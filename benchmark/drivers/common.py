"""What the drivers share: the port's configuration from the cell's files,
the budgets, the sample of judged batches, seeds."""

from __future__ import annotations

import gc
from types import SimpleNamespace

import numpy as np
import torch


def port_argv(conf: dict, traffic: dict) -> list[str]:
    """The argv of the port's ModelConfig: the configuration's flags, the
    traffic's mode and batch."""
    argv = list(conf["argv"]) + ["-b", str(traffic["batch"]), "-dtype", conf["compute_dtype"]]
    if "mode" in traffic:
        argv += ["-m", traffic["mode"]]
    return argv


def budgets(conf: dict, mode: str) -> SimpleNamespace:
    """The configuration's padding budgets (max_pairs_eval by mode)."""
    b = dict(conf["budgets"])
    sgdet, gtbox = b.pop("max_pairs_eval_sgdet"), b.pop("max_pairs_eval_gtbox")
    b["max_pairs_eval"] = sgdet if mode == "sgdet" else gtbox
    return SimpleNamespace(**b)


def check_port_config(cfg, conf: dict, mode: str) -> None:
    """The port's parsed configuration states the configuration file's
    widths and budgets."""
    want = {k: conf[k] for k in ("hidden_dim", "pooling_dim", "obj_dim", "embed_dim",
                                 "nl_obj", "nl_edge", "order", "use_bias", "use_tanh",
                                 "limit_vision", "compute_dtype") if k in conf}
    got = {k: getattr(cfg, k) for k in want}
    bud = vars(budgets(conf, mode))
    got_b = {k: getattr(cfg.budgets, k) for k in bud}
    if got != want or got_b != bud:
        raise RuntimeError(f"the port's configuration {got} {got_b} is not the file's "
                           f"{want} {bud}")


def seed_of(seed: int, salt: int) -> int:
    """A derived seed for one of the run's draws."""
    return int(np.random.SeedSequence([seed % (1 << 63), salt]).generate_state(1)[0])


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def reset_peak(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def peak_bytes(device) -> int:
    if torch.device(device).type == "cuda":
        return torch.cuda.max_memory_allocated(device)
    return 0


def free_device() -> None:
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def to_device(inputs: dict, device) -> dict:
    """`scenes.collate`'s numpy inputs as tensors on the device."""
    return {k: torch.as_tensor(v, device=device) for k, v in inputs.items()}


def limited(checks: dict, limits: dict) -> dict:
    """name -> (value, limit) for every number the limits file holds."""
    return {k: (float(checks[k]), float(limits[k])) for k in limits if k in checks}
