"""Op streams for kernel S and its plain fold (numpy only, so that the
card's tests, which import no JAX, share them with the CPU parity
tests): each exercises the fingers, the last insert's predecessors from
which an insert starts each level.  ``FINGER_STREAMS`` maps a name to a
function returning ``(kinds, keys)`` int32; ``FINGER_SHAPES`` maps it to
a function of the default max level giving ``(capacity, max_level)``.
"""

import numpy as np

# streams of 300 ops on a 512-slot state
T2, CAP2 = 300, 512


def _inserts(keys):
    return np.full(len(keys), 1, np.int32), np.asarray(keys, np.int32)


def _sample(seed, n, hi=3000):
    return np.sort(np.random.default_rng(seed).choice(hi, n, replace=False))


def _zigzag(seed):
    """Rising and falling inserts interleaved: each insert's fingers lie
    on the other side of it at every other op."""
    pool = _sample(seed, T2)
    out = np.empty(T2, np.int64)
    out[0::2], out[1::2] = pool[:T2 // 2], pool[T2 // 2:][::-1]
    return _inserts(out)


def _revive_fingers(seed):
    """An ascending populate, deletes of half of it, then inserts that
    revive marked keys, meet live ones and add new keys between them,
    with contains among them."""
    rng = np.random.default_rng(seed)
    pool = _sample(seed, 120, 1000)
    gone = rng.choice(pool, 60, replace=False)
    tail = np.concatenate([rng.permutation(gone)[:40], pool[::7],
                           rng.integers(0, 1000, 62)])
    tail = rng.permutation(tail)
    kinds = np.concatenate([np.full(120, 1), np.full(60, 2),
                            np.where(rng.random(len(tail)) < 0.8, 1, 0)])
    return (kinds.astype(np.int32),
            np.concatenate([pool, gone, tail]).astype(np.int32))


def _duplicates(seed):
    """Each key inserted two or three times in a row, and the stream
    repeated shuffled."""
    rng = np.random.default_rng(seed)
    pool = _sample(seed, 60, 1000)
    first = np.repeat(pool, rng.integers(2, 4, 60))[:T2 // 2]
    return _inserts(np.concatenate([first, rng.permutation(first)])[:T2])


def _mixed_fingers(seed):
    """An ascending populate of 150 keys, then a mix of all three kinds
    over and beside them, the int32 minimum and the head's key among
    them."""
    rng = np.random.default_rng(seed)
    pool = _sample(seed, 150, 2000)
    kinds = np.concatenate([np.full(150, 1),
                            rng.choice(3, T2 - 150, p=[0.4, 0.4, 0.2])])
    keys = np.concatenate([pool, np.where(rng.random(T2 - 150) < 0.6,
                                          rng.choice(pool, T2 - 150),
                                          rng.integers(-5, 2100, T2 - 150))])
    keys[[160, 170, 200, 230]] = -(2 ** 31), -(2 ** 31) + 1, -(2 ** 31), 7
    kinds[[160, 170, 200, 230]] = 1, 1, 0, 1
    return kinds.astype(np.int32), keys.astype(np.int32)


def _capacity_stop(seed):
    """Contains and ascending inserts into 64 slots: the 63rd insert of
    a new key finds the capacity exhausted, with every finger set."""
    rng = np.random.default_rng(seed)
    pool = _sample(seed, 100, 1000)
    kinds = np.ones(100, np.int32)
    kinds[rng.choice(100, 10, replace=False)] = 0
    return kinds, pool.astype(np.int32)


FINGER_STREAMS = {
    "fingers-ascending": lambda: _inserts(_sample(11, T2)),
    "fingers-descending": lambda: _inserts(_sample(12, T2)[::-1]),
    "fingers-zigzag": lambda: _zigzag(13),
    "fingers-revives": lambda: _revive_fingers(14),
    "fingers-duplicates": lambda: _duplicates(15),
    "fingers-capacity-stop": lambda: _capacity_stop(16),
    "fingers-max-level-1": lambda: _mixed_fingers(17),
    "fingers-max-level-33": lambda: _mixed_fingers(18),
}
FINGER_SHAPES = {name: (lambda ml: (CAP2, ml)) for name in FINGER_STREAMS}
FINGER_SHAPES.update({"fingers-capacity-stop": lambda ml: (64, ml),
                      "fingers-max-level-1": lambda ml: (CAP2, 1),
                      "fingers-max-level-33": lambda ml: (CAP2, 33)})
