"""train_imgs_per_s: Images of the steps completed in the window over the window's seconds,
the loader running (training cells)."""


def read(record):
    if record.entry != "train_loop" or not record.window_s or not record.images:
        return None
    return record.images / record.window_s
