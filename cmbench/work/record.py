"""Record the inputs of the port's hand-written kernels in eager steps and
turn them into bounds.

``recording`` wraps ``_ext.launch`` (the DP kernels) and the wrappers of
the ``launch_tensors`` kernels where the fused step calls them (frozen
copies of ``chip_smoke.py``'s ``recording_inputs`` and
``recording_tensor_kernels``): the first inputs of each (kernel, rows) are
kept and every call is counted; given ``bounds``, each call's own bound is
counted on its own inputs as it is made and summed per kernel, so that a
whole pass's bound is known.  A CUDA graph replay calls no wrapper, so the
step must run eagerly while it records.
"""

from __future__ import annotations

import collections
import contextlib
from typing import Dict, Iterator, Optional

from . import counts

# output columns of each DP kernel (chip_smoke.py's kernel_cases)
DP_COLUMNS = {"xdrop": 3, "edit_sc": 4, "edit_end": 2, "one_side": 1}
ScoreMat = collections.namedtuple("ScoreMat", "mat mis ind xd")

TENSOR_SITES = (("chain_cells", "chain_device", "chain_cells"),
                ("extract_kbest", "device_finish", "extract_kbest_device"),
                ("chain_dp", "chain_device", "chain_dp"),
                ("mr_pair_fold", "device_full", "mr_pair_fold"),
                ("walk_fold", "device_walk", "walk_fold_lanes"),
                ("tiny_dp", "device_walk", "tiny_dp"),
                ("tiny_dp", "device_full", "tiny_dp"),
                ("walk_scan", "device_walk", "walk_scan"),
                ("walk_init", "device_walk", "walk_init"),
                ("walk_pool", "device_walk", "walk_pool"),
                ("walk_commit", "device_walk", "walk_commit"),
                ("extend_core", "device_full", "extend_core"),
                ("extend_leftover", "device_full", "extend_leftover"),
                ("pair_grid", "device_full", "pair_grid"))


def _rows(name, args, kw) -> int:
    if name in counts.EXTEND_KERNELS:
        return args[{"extend_core": 0, "extend_leftover": 2}[name]].numel()
    if name == "walk_fold":
        return args[1].shape[1]
    if name in ("walk_scan", "walk_commit"):
        return args[0].shape[1] * args[0].shape[2]
    if name == "walk_init":
        return kw["WPP"]
    if name == "walk_pool":
        return kw["MIDP"] + kw["ENDP"]
    return args[0].shape[0]


@contextlib.contextmanager
def recording(dp: Dict, tensors: Dict,
              bounds: Optional[Dict[str, float]] = None) -> Iterator[None]:
    """Inside the region, keep the first inputs of each (kernel, rows) of
    the DP kernels in ``dp`` and of the ``launch_tensors`` kernels in
    ``tensors``, and count every call there; with ``bounds``, add each
    call's bound in ms, counted on its own inputs, to ``bounds[kernel]``."""
    import importlib
    from circminer_tpu_torch.ops import _ext
    launch = _ext.launch

    def record_dp(name, s, t, n, m, wv, ncols, I, statics):
        key = (name, s.shape[0])
        entry = dict(args=[x.clone() for x in (s, t, n, m)] + [
            None if wv is None else wv.clone()], statics=statics, count=0)
        dp.setdefault(key, entry)["count"] += 1
        if bounds is not None:
            bounds[name] = bounds.get(name, 0.0) + dp_bound(name, entry)
        return launch(name, s, t, n, m, wv, ncols, I, statics)

    def wrap(name, fn):
        def rec(*args, **kw):
            key = (name, _rows(name, args, kw))
            entry = dict(args=[a.clone() for a in args], kw=dict(kw),
                         count=0)
            tensors.setdefault(key, entry)["count"] += 1
            if bounds is not None:
                bounds[name] = bounds.get(name, 0.0) + \
                    counts.tensor_kernel_bound(name, entry["args"], kw)[0]
            return fn(*args, **kw)
        return rec

    mods = {m: importlib.import_module(f"circminer_tpu_torch.ops.{m}")
            for _, m, _ in TENSOR_SITES}
    saved = [(mods[m], attr, getattr(mods[m], attr))
             for _, m, attr in TENSOR_SITES]
    _ext.launch = record_dp
    for (name, _, _), (mod, attr, fn) in zip(TENSOR_SITES, saved):
        setattr(mod, attr, wrap(name, fn))
    try:
        yield
    finally:
        _ext.launch = launch
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)


def dp_bound(name: str, rec: Dict) -> float:
    """Bound ms of one launch of a DP kernel on its recorded inputs."""
    s, t, n, m, wv = (None if x is None else x.cpu().numpy()
                      for x in rec["args"])
    st = rec["statics"]
    w = st[0]
    sm = ScoreMat(*st[1:]) if name == "xdrop" else ScoreMat(0, 0, 0, 0)
    cells, diags = counts.work(name, s, t, n, m, wv, w, sm)
    return counts.bounds(name, s.shape[0], s.shape[1], DP_COLUMNS[name],
                         cells, diags)[0]
