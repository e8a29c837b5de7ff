"""Production meshes and the card's constants for the roofline (the
twin of ``repro.launch.mesh``).

Functions, not module constants, as in the reference.  Single pod:
16 x 16 = 256 ranks ``(data, model)``; multi-pod: 2 x 16 x 16 = 512
``(pod, data, model)``, the ``pod`` axis composing with ``data`` for
data parallelism and fsdp.  Here each is a
``sharding.AbstractMesh``: the axis names and sizes, standing for rank
0 of the mesh on the ``meta`` device, which is all the dry-run needs
(``launch/dryrun.py`` counts that rank's step without a world).

The constants are an NVIDIA H100 SXM's, one rank a card:
``PEAK_FLOPS_BF16`` its dense bf16 tensor-core rate and ``HBM_BW`` its
HBM3 rate (the figures ``scripts/card_checks.py`` uses), ``LINK_BW``
the bus bandwidth NCCL reached between four cards of one host, measured
by ``python3 chip_smoke.py --phase16 --backend nccl`` (the smaller of
the all-reduce's and the all-gather's at 256 MiB; NVIDIA H100 80GB
HBM3, 700.00 W).  An HGX H100 host joins 8 cards by NVSwitch; a
``model`` axis of 16 spans two such NVLink domains, whose traffic
crosses the hosts' network at a fraction of that rate, which a one-link
model does not capture.
"""

from __future__ import annotations

from repro_torch.parallel.sharding import AbstractMesh


def make_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    shape = ((("pod", 2), ("data", 16), ("model", 16)) if multi_pod
             else (("data", 16), ("model", 16)))
    return AbstractMesh(dict(shape))


def make_host_mesh() -> AbstractMesh:
    """The degenerate 1 x 1 mesh: every axis of one rank, so every
    collective is the identity and no process group is needed."""
    return AbstractMesh({"data": 1, "model": 1})


# NVIDIA H100 SXM constants for the roofline (launch/roofline.py)
PEAK_FLOPS_BF16 = 989e12          # dense bf16 FLOP/s a card
HBM_BW = 3.35e12                  # bytes/s a card
LINK_BW = 2.996345e11            # bytes/s a card, measured (see above)
