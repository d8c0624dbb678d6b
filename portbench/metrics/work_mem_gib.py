"""work_mem_gib: the operator's working memory -- the peak of
``torch.cuda.max_memory_allocated`` over the window less the bytes of the
resident input tensors, in GiB.  Not read off a card."""


def read(run):
    if run.device.type != "cuda":
        return None
    return (run.peak_bytes - run.resident_bytes) / 2 ** 30
