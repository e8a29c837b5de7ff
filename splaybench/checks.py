"""The comparison that decides ``correct``: the program's state and plane,
read back as NumPy arrays, against the reference's.

Every comparison is exact and counts the entries that differ, so each
number compared has the limit 0.  The state is compared in the
canonical form of :meth:`reference.SplayList.canon` (per physically
present node in key order; links as the successor's key), so slot
numbering, which is the program's own, does not enter; the plane is
compared field by field, and its slot companion by what it must point
at in the program's own state.
"""

from __future__ import annotations

import numpy as np

from splaybench.reference import NO_LINK, TAIL_KEY

HEAD, TAIL = 0, 1
PLANE_FIELDS = ("keys", "widths", "heights", "rank_map", "bot_rank",
                "slots")


def canon_arrays(s: dict) -> dict:
    """The canonical form of a program state given as arrays (the
    splay-list's twelve fields: ``key [C]``, ``nxt``/``hits [L+1, C]``,
    ``selfhits``, ``top``, ``nzero``, ``deleted [C]``, the scalars)."""
    key = s["key"].astype(np.int64)
    nxt = s["nxt"].astype(np.int64)
    hits = s["hits"].astype(np.int64)
    L = nxt.shape[0] - 1
    n_alloc = int(s["n_alloc"])
    slots = np.arange(2, n_alloc)
    order = slots[np.argsort(key[slots], kind="stable")]
    top = s["top"].astype(np.int64)[order]
    nzero = s["nzero"].astype(np.int64)[order]
    lv = np.arange(L + 1)[:, None]
    mat = (lv >= nzero[None, :]) & (lv <= top[None, :])

    def succ_keys(links):
        lk = np.where((links >= 0) & (links < key.shape[0]), links, 0)
        sk = np.where(lk == TAIL, TAIL_KEY, key[lk])
        return np.where(links >= 0, sk, NO_LINK)

    succ = np.where(mat, succ_keys(nxt[:, order]), NO_LINK)
    hh = np.where(mat, hits[:, order], 0)
    h_nz = int(s["nzero"][HEAD])
    h_mat = np.arange(L + 1) >= h_nz
    head_succ = np.where(h_mat, succ_keys(nxt[:, HEAD]), NO_LINK)
    head_hits = np.where(h_mat, hits[:, HEAD], 0)
    return dict(key=key[order], top=top, nzero=nzero,
                selfhits=s["selfhits"].astype(np.int64)[order],
                deleted=s["deleted"].astype(bool)[order], succ=succ,
                hits=hh, head_nzero=np.asarray([h_nz], np.int64),
                head_succ=head_succ, head_hits=head_hits,
                scalars=np.asarray([int(s["m"]), int(s["dhits"]),
                                    int(s["zl"]), int(s["size"]), n_alloc],
                                   np.int64))


def canon(state: dict) -> dict:
    """``state`` in the canonical form: the program's twelve fields as
    arrays are put into it, a canonical one is returned as it is."""
    return state if "succ" in state else canon_arrays(state)


def live_heights(state: dict):
    """``(keys, relative heights)`` of the unmarked nodes of a state (as
    :func:`canon` takes it), ascending by key, as
    :meth:`reference.SplayList.live_heights` gives the reference's."""
    c = canon(state)
    live = ~c["deleted"]
    return c["key"][live], c["top"][live] - int(c["scalars"][2])


def diff_count(a: dict, b: dict) -> int:
    """Entries that differ between two dicts of arrays with the same
    keys; an array whose shape differs counts as wholly different."""
    out = 0
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        if x.shape != y.shape:
            out += max(x.size, y.size, 1)
        else:
            out += int(np.count_nonzero(x != y))
    return out


def state_diff(state: dict, ref) -> int:
    """Entries of a state that differ from the reference's.  ``state``
    is the program's twelve fields as arrays, or already canonical."""
    return diff_count(canon(state), ref.canon())


def plane_diff(plane: dict, ref_plane: dict, state: dict) -> int:
    """Entries of a plane that differ from the reference's, plus, where
    the plane carries the slot companion, each live lane of it that does
    not name the slot of that bottom-row key in the program's ``state``."""
    out = diff_count({k: plane[k] for k in ref_plane}, ref_plane)
    if "slots" not in plane:
        return out
    n_live = int(np.asarray(ref_plane["widths"])[-1])
    bottom = np.asarray(plane["keys"])[-1][:n_live]
    slots = np.asarray(plane["slots"])[:n_live].astype(np.int64)
    key = np.asarray(state["key"])
    ok = (slots >= 2) & (slots < key.shape[0])
    ok[ok] = key[slots[ok]] == bottom[ok]
    return out + int(np.count_nonzero(~ok))
