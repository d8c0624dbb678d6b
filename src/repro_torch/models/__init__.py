"""The LM stack of every family (dense, moe, hybrid, xlstm, audio, vlm):
configuration, shared layers, attention, MoE, SSM and xLSTM blocks, the
chunked recurrent scan, the stacked-unit layer loop and the model."""
