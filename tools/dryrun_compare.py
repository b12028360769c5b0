#!/usr/bin/env python3
"""Hold the port's dry-run records against the reference's, tag by tag.

    python3 tools/dryrun_compare.py [--ref artifacts/dryrun]
        [--port artifacts/dryrun_torch] [--json OUT.json] [--markdown]
        [--faults-only] [--recount COUNTS.jsonl]

The reference's records come from ``python -m repro.launch.dryrun --all
--mesh both``, the port's from ``python -m repro_torch.launch.dryrun``
(both write one JSON file a cell). Each tag gets one line: both statuses;
the port's ``peak_bytes`` beside the reference's ``peak_bytes_tpu`` and
their ratio; ``fits_hbm`` beside ``fits_hbm_tpu``; ``collective_bytes`` in
total and by op, with the ratio; the ratios of ``hlo_flops``,
``hlo_bytes`` and ``model_flops``; the ratio of each of the 12 features;
the port's counting seconds (``lower_s``). The port counts no f32 upcast
(its peak is a bf16 program's), so the reference's TPU peak is its
yardstick.

A cell is a FAULT where
  (a) the statuses differ,
  (b) ``fits_hbm`` differs from the reference's ``fits_hbm_tpu``,
  (c) the peak is more than PEAK_LIMIT x ``peak_bytes_tpu``,
  (d) ``collective_bytes`` is more than COLL_LIMIT x the reference's,
  (e) ``model_flops`` differs (both compute it by one formula), or
  (f) the reference's record has the 12 features and the port's has none
      (``workloads/collect.py::cells_dataset`` skips such a record).
FLOPs, bytes and features are printed and are no criterion: the port
counts an eager run, the reference a compiled module. Exits 1 where any
cell is a fault or a record is missing on either side. The records are
host counts, not times: nothing runs on a card.

``--recount FILE`` holds the port's records against a second count of
the same cells instead: FILE holds ``tools/mesh_peaks.py``'s JSON lines
(full-depth cells, ``--shape`` and ``--multipod`` as the tags name them),
for instance counted under another torch; each line's peak and total
collective bytes beside the record's, and a cell whose two counts are
more than RECOUNT_LIMIT apart is a fault.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
PEAK_LIMIT = 1.15
COLL_LIMIT = 1.25
RECOUNT_LIMIT = 0.01
FEATURES = ("work_per_shard", "num_shards", "total_instr", "arith_ops",
            "special_ops", "logic_ops", "control_ops", "sync_ops",
            "global_mem_vol", "param_mem_vol", "shared_mem_vol",
            "arith_intensity")


def _ratio(a, b):
    if a is None or b is None:
        return None
    if b == 0:
        return None if a else 1.0
    return a / b


def _load(folder: Path) -> dict:
    out = {}
    for path in sorted(folder.glob("*.json")):
        with open(path) as f:
            rec = json.load(f)
        out[rec.get("tag", path.stem)] = rec
    return out


def compare(ref: dict, port: dict) -> dict:
    """The line of one tag: ``ref`` and ``port`` its two records (either
    may be None)."""
    row = {"ref_status": ref and ref.get("status"),
           "port_status": port and port.get("status")}
    faults = []
    if row["ref_status"] != row["port_status"]:
        faults.append("a")
    if port and port.get("status") == "error":
        row["error"] = port.get("error")
    r = (ref or {}).get("report")
    p = (port or {}).get("report")
    if r and p:
        row.update(
            peak_gib=p["peak_bytes"] / 2 ** 30,
            ref_peak_tpu_gib=r["peak_bytes_tpu"] / 2 ** 30,
            peak_ratio=_ratio(p["peak_bytes"], r["peak_bytes_tpu"]),
            fits_hbm=p["fits_hbm"], ref_fits_hbm_tpu=r["fits_hbm_tpu"],
            collective_bytes=p["collective_bytes"],
            ref_collective_bytes=r["collective_bytes"],
            coll_ratio=_ratio(p["collective_bytes"], r["collective_bytes"]),
            collective_by_op=p["collective_breakdown"],
            ref_collective_by_op=r["collective_breakdown"],
            flops_ratio=_ratio(p["hlo_flops"], r["hlo_flops"]),
            bytes_ratio=_ratio(p["hlo_bytes"], r["hlo_bytes"]),
            model_flops_ratio=_ratio(p["model_flops"], r["model_flops"]),
            seconds=port.get("lower_s"))
        if p["fits_hbm"] != r["fits_hbm_tpu"]:
            faults.append("b")
        if row["peak_ratio"] is not None and row["peak_ratio"] > PEAK_LIMIT:
            faults.append("c")
        if row["coll_ratio"] is None or row["coll_ratio"] > COLL_LIMIT:
            faults.append("d")
        if p["model_flops"] != r["model_flops"]:
            faults.append("e")
        rf, pf = ref.get("features") or {}, port.get("features") or {}
        if rf and not pf:
            faults.append("f")
        row["feature_ratios"] = {n: _ratio(pf.get(n), rf.get(n))
                                 for n in FEATURES}
    row["faults"] = faults
    return row


def _fmt(v, spec=".3g") -> str:
    return "-" if v is None else format(v, spec)


def line(tag: str, row: dict) -> str:
    mark = "FAULT " + "".join(row["faults"]) if row["faults"] else "ok"
    head = f"{mark:9s} {tag}  {row['ref_status']}/{row['port_status']}"
    if "peak_ratio" not in row:
        return head + (f"  error: {row['error']}" if row.get("error") else "")
    ops = " ".join(f"{k}={v:.3g}" for k, v in
                   sorted(row["collective_by_op"].items()))
    feats = " ".join(f"{k}={_fmt(v)}" for k, v in
                     row["feature_ratios"].items())
    return (f"{head}  peak {row['peak_gib']:.3f}/{row['ref_peak_tpu_gib']:.3f}"
            f" GiB x{_fmt(row['peak_ratio'])}"
            f"  fits {row['fits_hbm']}/{row['ref_fits_hbm_tpu']}"
            f"  coll {row['collective_bytes']:.3e}/"
            f"{row['ref_collective_bytes']:.3e} x{_fmt(row['coll_ratio'])}"
            f" [{ops}]  flops x{_fmt(row['flops_ratio'])}"
            f" bytes x{_fmt(row['bytes_ratio'])}"
            f" model_flops x{_fmt(row['model_flops_ratio'])}"
            f"  {_fmt(row['seconds'], '.1f')} s  features: {feats}")


def markdown(table: dict) -> str:
    """One row a cell, its two meshes side by side (pod16x16 /
    pod2x16x16): statuses, the port's peak and the ratios to the
    reference's, the counting seconds and the faults; the cells that
    both sides skip on both meshes in one last row."""
    out = ["| arch, shape | status | peak GiB (ratio to `mem_tpu`) | "
           "coll ratio | flops ratio | s | fault |",
           "|---|---|---|---|---|---|---|"]
    cells: dict = {}
    skipped: list = []
    for tag, row in table.items():
        arch, shape, mesh, _ = tag.split("__")
        cells.setdefault((arch, shape), {})[mesh] = row
    for (arch, shape), rows in cells.items():
        pair = [rows.get("pod16x16", {}), rows.get("pod2x16x16", {})]

        def both(fn):
            return " / ".join(fn(r) if r else "-" for r in pair)
        status = both(lambda r: r["port_status"] or "none")
        if all(r.get("ref_status") == r.get("port_status") == "skipped"
               for r in pair):
            skipped.append(f"{arch} {shape}")
            continue
        out.append(
            f"| {arch} {shape} | {status} | "
            + both(lambda r: f"{r['peak_gib']:.2f} ({r['peak_ratio']:.2f})"
                   if "peak_ratio" in r else "-") + " | "
            + both(lambda r: _fmt(r.get("coll_ratio"), ".2f")) + " | "
            + both(lambda r: _fmt(r.get("flops_ratio"), ".2f")) + " | "
            + both(lambda r: _fmt(r.get("seconds"), ".0f")) + " | "
            + both(lambda r: "".join(r["faults"]) or "-") + " |")
    if skipped:
        out.append(f"| {', '.join(skipped)} | skipped / skipped, as the "
                   "reference's | | | | | - / - |")
    return "\n".join(out)


def recount(port: dict, path: Path) -> int:
    """Print each counted cell of ``path`` beside its record; the number of
    cells more than RECOUNT_LIMIT apart, or without a record."""
    bad = 0
    for text in path.read_text().splitlines():
        if not text.startswith("{"):
            continue
        c = json.loads(text)
        mesh = "pod2x16x16" if len(c["mesh"]) == 3 else "pod16x16"
        tag = (f"{c['arch']}__{c.get('shape', 'train_4k')}__{mesh}__"
               f"{c['strategy']}")
        rec = (port.get(tag) or {}).get("report")
        if rec is None:
            print(f"FAULT     {tag}  no record")
            bad += 1
            continue
        coll = sum(c["collective_bytes"].values())
        dp = _ratio(c["peak_bytes"], rec["peak_bytes"])
        dc = _ratio(coll, rec["collective_bytes"])
        far = [r for r in (dp, dc) if r is None or abs(r - 1) > RECOUNT_LIMIT]
        bad += bool(far)
        print(f"{'FAULT' if far else 'ok':9s} {tag}  torch {c['torch']}  "
              f"peak {c['peak_bytes']}/{rec['peak_bytes']} x{_fmt(dp, '.6f')}"
              f"  coll {coll:.6e}/{rec['collective_bytes']:.6e} "
              f"x{_fmt(dc, '.6f')}  {c['seconds']:.1f} s")
    return bad


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ref", type=Path, default=REPO / "artifacts" / "dryrun")
    ap.add_argument("--port", type=Path,
                    default=REPO / "artifacts" / "dryrun_torch")
    ap.add_argument("--json", type=Path, default=None,
                    help="write the table here")
    ap.add_argument("--markdown", action="store_true",
                    help="print a markdown table after the lines, a "
                         "row a cell with its two meshes")
    ap.add_argument("--faults-only", action="store_true")
    ap.add_argument("--recount", type=Path, default=None,
                    help="tools/mesh_peaks.py lines to hold the records to")
    args = ap.parse_args(argv)
    ref, port = _load(args.ref), _load(args.port)
    if args.recount:
        bad = recount(port, args.recount)
        print(f"\n{bad} cells apart or without a record")
        return 1 if bad else 0
    table = {tag: compare(ref.get(tag), port.get(tag))
             for tag in sorted(set(ref) | set(port))}
    for tag, row in table.items():
        if row["faults"] or not args.faults_only:
            print(line(tag, row))
    faults = [t for t, r in table.items() if r["faults"]]
    print(f"\n{len(table)} cells, {len(ref)} reference records, "
          f"{len(port)} port records, {len(faults)} faults")
    if args.markdown:
        print(markdown(table))
    if args.json:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps(table, indent=1))
    return 1 if faults else 0


if __name__ == "__main__":
    sys.exit(main())
