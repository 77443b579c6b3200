"""peak_mem_gib.infer: torch.cuda.max_memory_allocated over the window, GiB (eval cells)."""


def read(record):
    if record.entry != "eval_loop" or record.peak_window_bytes is None:
        return None
    return record.peak_window_bytes / 2 ** 30
