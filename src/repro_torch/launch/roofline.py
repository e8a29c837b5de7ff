"""The roofline terms of a dry-run cell (the twin of
``repro.launch.roofline``), in seconds, at the card's constants
(``launch/mesh.py``):

    compute    = flops (a rank)      / PEAK_FLOPS_BF16
    memory     = bytes (a rank)      / HBM_BW
    collective = wire bytes (a rank) / LINK_BW

The reference reads its flops and bytes from XLA's ``cost_analysis``
and its collectives from the optimized HLO.  The port has no compiler
output: the dry-run counts a rank's step on the meta device, and its
collectives are the records of ``collectives.recording()``, ``(kind,
bytes, group size)``, priced by the reference's ring model:

    all-reduce          2 * size * (g-1)/g
    all-gather          size_result * (g-1)/g
    reduce-scatter      size_result * (g-1)
    all-to-all          size * (g-1)/g
    collective-permute  size
"""

from __future__ import annotations

from typing import Dict, Iterable, Tuple

from repro_torch.launch import mesh as _mesh


def wire_bytes(kind: str, size: int, g: int) -> int:
    """The bytes a rank sends for one collective of ``kind`` over ``g``
    ranks whose sized type is ``size`` bytes (the reference's
    ``parse_collectives`` rule, integer division included)."""
    if kind == "collective-permute":
        return size                  # point-to-point, no groups
    if g <= 1:
        return 0
    if kind == "all-reduce":
        return 2 * size * (g - 1) // g
    if kind == "all-gather":
        return size * (g - 1) // g
    if kind == "reduce-scatter":
        return size * (g - 1)        # size is the scattered result
    if kind == "all-to-all":
        return size * (g - 1) // g
    return size


def tally(records: Iterable[Tuple[str, int, int]]) -> Dict[str, dict]:
    """``{kind: {"count", "wire_bytes"}}`` of a recorder's ``(kind,
    bytes, group size)`` records, as ``parse_collectives`` gives them."""
    out: Dict[str, dict] = {}
    for kind, size, g in records:
        rec = out.setdefault(kind, {"count": 0, "wire_bytes": 0})
        rec["count"] += 1
        rec["wire_bytes"] += wire_bytes(kind, size, g)
    return out


def roofline_terms(flops_per_dev: float, bytes_per_dev: float,
                   wire_bytes_per_dev: float) -> dict:
    compute_s = flops_per_dev / _mesh.PEAK_FLOPS_BF16
    memory_s = bytes_per_dev / _mesh.HBM_BW
    coll_s = wire_bytes_per_dev / _mesh.LINK_BW
    dominant = max(
        (("compute", compute_s), ("memory", memory_s),
         ("collective", coll_s)), key=lambda kv: kv[1])[0]
    total = max(compute_s, memory_s, coll_s)
    return {
        "compute_s": compute_s, "memory_s": memory_s,
        "collective_s": coll_s, "dominant": dominant,
        "roofline_fraction": compute_s / total if total > 0 else 0.0,
    }


def model_flops(cfg, seq_len: int, global_batch: int, kind: str) -> float:
    """MODEL_FLOPS = 6*N*D (train) / 2*N*D (prefill) / 2*N_active*B
    (decode, per step); MoE uses active params."""
    n = cfg.n_active_params()
    if kind == "train":
        return 6.0 * n * seq_len * global_batch
    if kind == "prefill":
        return 2.0 * n * seq_len * global_batch
    return 2.0 * n * global_batch     # decode: one token per sequence


def summarize(cell: dict) -> str:
    t = cell["roofline"]
    return (f"{cell['arch']:22s} {cell['shape']:12s} {cell['mesh']:6s} "
            f"compute={t['compute_s']:.3e}s memory={t['memory_s']:.3e}s "
            f"coll={t['collective_s']:.3e}s dom={t['dominant']:10s} "
            f"useful={cell.get('useful_flops_ratio', 0):.2f}")
