"""The LM stack of the dense families (dense, audio, vlm): configuration,
shared layers, attention, the stacked-unit layer loop and the model."""
