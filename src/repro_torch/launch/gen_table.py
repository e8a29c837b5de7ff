"""The roofline table in markdown from the dry-run's JSONs (the twin of
``repro.launch.gen_table``).

  PYTHONPATH=src python -m repro_torch.launch.gen_table DIR [PATH]

prints the table of the single-mesh cells under ``DIR`` and, given
``PATH``, splices it into that markdown file after its
``<!-- ROOFLINE_TABLE -->`` marker (idempotent: what followed the
marker is replaced)."""

from __future__ import annotations

import glob
import json
import os
import sys

MARKER = "<!-- ROOFLINE_TABLE -->"


def build_table(dryrun_dir: str) -> str:
    rows = []
    for f in sorted(glob.glob(os.path.join(dryrun_dir,
                                           "*__single.json"))):
        with open(f) as fh:
            d = json.load(fh)
        t = d["roofline"]
        mem = d.get("memory_analysis", {})
        rows.append((
            d["arch"], d["shape"], t["compute_s"], t["memory_s"],
            t["collective_s"], t["dominant"], d["useful_flops_ratio"],
            (mem.get("temp_size_in_bytes", 0) +
             mem.get("argument_size_in_bytes", 0)) / 1e9))
    rows.sort()
    lines = [
        "| arch | shape | compute s | memory s | collective s | dominant "
        "| useful | dev GB (arg+temp) |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        lines.append(
            f"| {r[0]} | {r[1]} | {r[2]:.3e} | {r[3]:.3e} | {r[4]:.3e} "
            f"| {r[5]} | {r[6]:.2f} | {r[7]:.1f} |")
    multi = len(glob.glob(os.path.join(dryrun_dir, "*__multi.json")))
    single = len(rows)
    lines.append("")
    lines.append(f"Cells compiled: {single} single-pod (probed) + "
                 f"{multi} multi-pod (2×16×16) = {single + multi}.")
    return "\n".join(lines)


def splice(path: str, table: str) -> None:
    """Replace what follows ``MARKER`` in the file at ``path`` by
    ``table`` (the marker is appended when the file lacks it)."""
    text = open(path).read() if os.path.exists(path) else ""
    head = text.split(MARKER)[0]
    with open(path, "w") as f:
        f.write(head + MARKER + "\n\n" + table + "\n")


def main(argv=None) -> str:
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        raise SystemExit("usage: gen_table DRYRUN_DIR [MARKDOWN_PATH]")
    table = build_table(argv[0])
    if len(argv) > 1:
        splice(argv[1], table)
    print(table)
    return table


if __name__ == "__main__":
    main()
