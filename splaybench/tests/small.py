"""Sizes at which the tests drive whole runs on the CPU: each cell's
configuration and traffic, cut to 600 keys and a batch of 64 (the
program's plain CPU versions run here).  The read-write cell's hot set
is widened to 5% of the keys: at 600 keys its 1% is 6 keys, which the
write set (25% of the keys) often misses entirely, and then no read in
a run sees a write of its batch."""

READ = "zipf1-1e5.read-b262144"
RW = "rw99-1-1e5.rw98-b16384"


def sizes(workload: str) -> dict:
    cfg = {"keys": 600, "capacity": 602, "max_level": 12,
           "plane": {"levels": 12, "width": 1024}}
    if workload == READ:
        cfg["key_space"] = 600
    else:
        cfg.update(key_space=1200,
                   read_keys={"dist": "hotset", "x": 0.99, "y": 0.05})
    return {"config": cfg, "traffic": {"batch": 64, "warmup_batches": 1}}


def control_sizes(workload: str) -> dict:
    """The sizes of a control's test: as :func:`sizes`, but the
    read-write cell's breach made frequent, so that a window of a few
    batches shows it whatever the machine's speed: 100 keys, every one a
    write key, uniform reads, 10% inserts and 10% deletes, so that about
    one read a batch follows a write of its key that changed its
    membership."""
    s = sizes(workload)
    if workload == RW:
        s["config"].update(keys=100, key_space=200, capacity=102,
                           read_keys={"dist": "uniform"},
                           write_keys={"share": 1.0})
        s["traffic"]["mix"] = {"contains": 0.8, "insert": 0.1,
                               "delete": 0.1}
    return s
