"""Observation of the port's kernel entries during a profiled slice: each
launch's shapes (and for the NMS kernels their outputs, to count the IoU
tests the data needed), by wrapping `roi_align_cuda`, `roi_align_bwd_cuda`,
`greedy_nms_cuda` and `perclass_nms_cuda` in their modules for the slice
only. The bounds are summed once the slice is over."""

from __future__ import annotations

import torch

from benchmark.arith import roofline as R

_ENTRIES = (("neural_motifs_tpu_torch.ops.roi_align", "roi_align_cuda"),
            ("neural_motifs_tpu_torch.ops.roi_align", "roi_align_bwd_cuda"),
            ("neural_motifs_tpu_torch.ops.nms", "greedy_nms_cuda"),
            ("neural_motifs_tpu_torch.ops.nms", "perclass_nms_cuda"))


class Observer:
    def __init__(self):
        self.launches = []
        self._saved = []

    def install(self) -> None:
        import importlib
        for mod_name, fn_name in _ENTRIES:
            mod = importlib.import_module(mod_name)
            orig = getattr(mod, fn_name)
            wrapper = self._wrap(fn_name, orig)
            wrapper.launches = orig.launches
            setattr(mod, fn_name, wrapper)
            self._saved.append((mod, fn_name, orig, wrapper))

    def uninstall(self) -> None:
        for mod, fn_name, orig, wrapper in self._saved:
            orig.launches = wrapper.launches
            setattr(mod, fn_name, orig)
        self._saved = []

    def _wrap(self, kind: str, fn):
        def call(*args, **kw):
            out = fn(*args, **kw)
            self.launches.append(_launch(kind, args, out))
            return out
        return call

    def bound_ms(self) -> float:
        """The summed least time of the observed launches."""
        total = 0.0
        for kind, a in self.launches:
            if kind == "roi_align_cuda":
                total += R.roi_align_bound(*a)[0]
            elif kind == "roi_align_bwd_cuda":
                total += R.roi_align_bwd_bound(*a)[0]
            elif kind == "greedy_nms_cuda":
                scores, valid, keep = a
                masked = torch.where(valid, scores, torch.full_like(scores, -float("inf")))
                order = torch.sort(masked, dim=1, descending=True, stable=True).indices
                pairs = R.greedy_pairs(keep.gather(1, order), valid.gather(1, order))
                total += R.nms_bound(scores.numel(), 16 + 4 + 1 + 1, pairs)[0]
            elif kind == "perclass_nms_cuda":
                valid, keep = a
                total += R.nms_bound(valid.numel(), 16 + 1 + 1, R.greedy_pairs(keep, valid))[0]
        return total


def _launch(kind: str, args: tuple, out) -> tuple:
    """What a launch's bound needs: the RoIAlign shapes; the NMS scores,
    flags and keep masks (small), never the crops."""
    if kind == "roi_align_cuda":
        fmap, rois = args[0], args[1]
        return kind, (*fmap.shape, rois.shape[1], args[3], fmap.element_size())
    if kind == "roi_align_bwd_cuda":
        g, rois, fmap_shape, fmap_dtype = args[0], args[1], args[3], args[4]
        elem = torch.empty((), dtype=fmap_dtype).element_size()
        return kind, (*fmap_shape, rois.shape[1], g.shape[2], elem)
    if kind == "greedy_nms_cuda":
        return kind, (args[1], args[2], out)
    return kind, (args[1], out)
