"""infer_imgs_per_s: Images consumed in the window over the window's seconds (eval cells)."""


def read(record):
    if record.entry != "eval_loop" or not record.window_s or not record.images:
        return None
    return record.images / record.window_s
