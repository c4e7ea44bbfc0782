"""Roofline analysis over the port's dry-run records (port of
``repro/launch/roofline.py``).

Hardware model: one NVIDIA H100 80GB HBM3 (SXM) at its 700 W power limit,
from NVIDIA's public figures (a card set to a lower limit runs slower under
load; ``chip_smoke.py`` prints the card's own name and limit beside):
  peak_flops = 989e12  bf16 dense FLOP/s per card
  hbm_bw     = 3.35e12 B/s per card
  link_bw    = 450e9   B/s per direction (NVLink 4, 18 links)

Per (arch x shape x mesh) cell, from the dry run's per-device figures
(``launch/dryrun.py``: the global program's FLOPs and traffic proxy split
evenly over the mesh's devices):
  t_compute = flops_per_device / peak_flops
  t_memory  = (argument + output bytes, traffic_bytes_proxy) / hbm_bw — a
              range: the exact bytes any program must move, to the
              unfused proxy (no XLA cost analysis to place it)
  t_coll    = collective_bytes_total / link_bw — not measured on one card
              (the record's null); shown as "—", never as 0
Bottleneck = the measured term whose low end is above every other term's
high end, else "undetermined" (listed under ``unmeasured`` with its
reason); the roofline fraction is a range, t_compute over the largest
term's high end and low end.

MODEL_FLOPS:
  train   : 6 * N(active) * tokens  (the standard MFU numerator)
  prefill : 2 * N(active) * tokens
  decode  : 2 * N(active) * batch   (one token per sequence)
(attention's O(S^2) term is excluded by convention; the counted/MODEL
ratio therefore runs >1 for remat (x4/3) and long-context attention.)

Usage:
  PYTHONPATH=src python -m repro_torch.launch.roofline [--tag baseline] [--md out.md]
"""
from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Dict, List, Optional, Tuple

CARD = "NVIDIA H100 80GB HBM3, 700.00 W"  # the card the constants are for
PEAK_FLOPS = 989e12
HBM_BW = 3.35e12
LINK_BW = 450e9

SHAPE_TOKENS = {
    "train_4k": 4096 * 256,
    "prefill_32k": 32768 * 32,
    "decode_32k": 128,
    "long_500k": 1,
}


def model_flops(rec: Dict) -> float:
    n = rec["n_active_params"]
    shape = rec["shape"]
    toks = SHAPE_TOKENS[shape]
    if shape == "train_4k":
        return 6.0 * n * toks
    return 2.0 * n * toks


def load(tag: str, out_dir: str = "experiments/dryrun_torch") -> List[Dict]:
    recs = []
    for p in sorted(glob.glob(os.path.join(out_dir, tag, "*.json"))):
        with open(p) as f:
            recs.append(json.load(f))
    return recs


def mem_bytes(rec: Dict) -> Tuple[float, float]:
    """HBM bytes per device as a range (low, high). Low: the per-device
    argument and output bytes, exact from the specs (each argument read
    once, each output written once; no program moves less). High: the
    traffic proxy (every eager op's output written and read once, unfused,
    split evenly over the mesh), or low where the proxy is smaller. The
    reference scales XLA's 'bytes accessed' by a loop trip ratio and caps
    it by the proxy; no cost analysis exists here
    (``bytes_accessed_per_device`` is null), so the fused traffic lies
    somewhere in the range."""
    m = rec["memory"]
    low = float(m["argument_size_in_bytes"] + m["output_size_in_bytes"])
    return low, max(low, float(rec["traffic_bytes_proxy"]))


UNDETERMINED = (
    "t_compute falls inside t_memory's range (argument and output bytes "
    "to the unfused traffic proxy): without XLA's fused traffic, neither "
    "term is known to be the larger")


def terms(rec: Dict, chips: int) -> Dict:
    f = rec["flops_per_device"]
    t_c = f / PEAK_FLOPS
    m_lo, m_hi = mem_bytes(rec)
    t_m = (m_lo / HBM_BW, m_hi / HBM_BW)
    coll = rec.get("collective_bytes_total")
    t_x: Optional[float] = None if coll is None else coll / LINK_BW
    ranges = {"compute": (t_c, t_c), "memory": t_m}
    if t_x is not None:
        ranges["collective"] = (t_x, t_x)
    # a term bounds the step only if its low end is above every other
    # term's high end
    dom = next((k for k, (lo, _) in ranges.items()
                if all(lo >= hi for j, (_, hi) in ranges.items() if j != k)),
               "undetermined")
    t_max_lo = max(max(lo for lo, _ in ranges.values()), 1e-30)
    t_max_hi = max(max(hi for _, hi in ranges.values()), 1e-30)
    mf = model_flops(rec)
    total = f * chips
    useful = mf / chips / PEAK_FLOPS
    return dict(
        t_compute=t_c,
        t_memory=t_m,
        t_collective=t_x,
        bottleneck=dom,
        unmeasured=({"bottleneck": UNDETERMINED}
                    if dom == "undetermined" else {}),
        model_flops=mf,
        counted_flops_total=total,
        useful_ratio=mf / max(total, 1e-30),
        roofline_fraction=(t_c / t_max_hi, t_c / t_max_lo),
        useful_roofline_fraction=(useful / t_max_hi, useful / t_max_lo),
    )


_SUGGEST = {
    "collective": "reduce cross-device bytes: reduce-scatter grads instead "
    "of per-microbatch all-reduce, overlap with compute",
    "memory": "cut HBM traffic: fuse elementwise chains, bf16 cache/grads, "
    "larger attention chunks (fewer score re-reads)",
    "compute": "raise tensor-core utilization: remove remat waste or "
    "non-useful FLOPs (dense MoE dispatch -> ragged), grow per-card batch",
}


def _s(t) -> str:
    """A time or a fraction: "—" where not measured, "lo–hi" for a
    range."""
    if t is None:
        return "—"
    if isinstance(t, tuple):
        return f"{t[0]:.3g}–{t[1]:.3g}"
    return f"{t:.3g}"


def table(recs: List[Dict]) -> str:
    lines = [
        f"Constants: {CARD}: {PEAK_FLOPS:.3g} FLOP/s bf16, "
        f"{HBM_BW:.3g} B/s HBM, {LINK_BW:.3g} B/s NVLink; t_coll not "
        f"measured (—); t_mem and the roofline share are ranges (argument "
        f"and output bytes to the unfused traffic proxy); bound "
        f"'undetermined' where t_comp falls inside t_mem's range.",
        "",
        "| arch | shape | mesh | t_comp(s) | t_mem(s) | t_coll(s) | bound | "
        "MODEL/counted | roofline | next lever |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in recs:
        if r["status"] == "skipped":
            lines.append(
                f"| {r['arch']} | {r['shape']} | {r['mesh']} | — | — | — | "
                f"skip | — | — | {r['reason'][:60]} |"
            )
            continue
        if r["status"] != "ok":
            lines.append(
                f"| {r['arch']} | {r['shape']} | {r['mesh']} | — | — | — | "
                f"ERROR | — | — | {r.get('error', '')[:60]} |"
            )
            continue
        chips = 512 if "2x16" in r["mesh"] else 256
        t = terms(r, chips)
        lines.append(
            "| {arch} | {shape} | {mesh} | {tc} | {tm} | {tx} | "
            "{b} | {ur:.3f} | {rf} | {sg} |".format(
                arch=r["arch"], shape=r["shape"], mesh=r["mesh"],
                tc=_s(t["t_compute"]), tm=_s(t["t_memory"]),
                tx=_s(t["t_collective"]), b=t["bottleneck"],
                ur=t["useful_ratio"], rf=_s(t["useful_roofline_fraction"]),
                sg=_SUGGEST.get(t["bottleneck"], "—")[:70],
            )
        )
    return "\n".join(lines)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tag", default="baseline")
    ap.add_argument("--dir", default="experiments/dryrun_torch",
                    help="the dry run's --out")
    ap.add_argument("--md", default="experiments/roofline_torch_baseline.md")
    ap.add_argument("--mesh", default="pod16x16",
                    help="roofline table mesh (single-pod per spec)")
    args = ap.parse_args()
    recs = load(args.tag, args.dir)
    single = [r for r in recs if r["mesh"] == args.mesh]
    md = table(single)
    os.makedirs(os.path.dirname(args.md) or ".", exist_ok=True)
    with open(args.md, "w") as f:
        f.write(f"# Roofline — tag={args.tag} mesh={args.mesh}\n\n{md}\n")
    print(md)


if __name__ == "__main__":
    main()
