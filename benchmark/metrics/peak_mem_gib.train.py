"""peak_mem_gib.train: torch.cuda.max_memory_allocated over the window, GiB (training)."""


def read(record):
    if record.entry != "train_loop" or record.peak_window_bytes is None:
        return None
    return record.peak_window_bytes / 2 ** 30
