#!/usr/bin/env python3
"""Time design variants of the port's K6 (grouped matrix product) on one GPU.

    python3 k6_variants.py [--out PATH]

K6's TMA path (``src/repro_torch/kernels/csrc/ragged_dot.cu``) walks (64-row
tile of one group) x (128-column tile) items on a persistent grid, fed by a
ring of four 24 KB TMA stages; bfloat16 multiplies with ``wgmma``, float32
with eight consumer warps, each eight rows of the tile and a 4 x 8 fmaf
micro-tile per lane. This script builds variants of that source beside it
and times them against the committed kernel:

  * ``ring3`` / ``ring6``: three or six ring stages (both dtypes; six
    leave room for one CTA an SM, three and four for two);
  * ``half_width`` (float32): a tile of at most 32 rows gives each warp 8
    rows and one 64-column half, so twice as many warps share its rows;
  * ``column_split`` (float32): warp w takes columns 16 w .. 16 w + 15 of
    every row the tile has (a lane 4 columns of rows ty + 8 i), so all
    eight warps carry equal work; lhs in the 128-byte swizzle, so a warp's
    eight rows fall in eight bank groups;
  * ``tile_8x8`` (float32): four consumer warps of 16 rows, an 8 x 8 fmaf
    micro-tile per lane (16 shared-memory loads per 256 FMAs against 12 per
    128).

The inputs are ``chip_smoke.k6_inputs`` from seed 17 at
``chip_smoke.K6_SHAPES`` and the empty-groups case (M 1000, K 256, N 192,
G 40). Every variant must equal the committed kernel bit for bit (the
float32 sums are one fmaf chain in every layout; a ring's depth changes
no sum). Each is timed (``chip_smoke.device_ms``, 20 calls) in two rounds,
the second in the reverse order. Prints the card and one JSON object,
also written to ``--out`` (by default ``build/k6_variants/summary.json``).
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
WORK = ROOT / "build" / "k6_variants"
SOURCE = ROOT / "src" / "repro_torch" / "kernels" / "csrc" / "ragged_dot.cu"
START = "    // -- the float32 consumers\n"
END = "    // -- end of the float32 consumers\n"
STAGES = "constexpr int STAGES = 4;"
F32_KERNEL = ("template <bool TB>\n"
              "__global__ void __launch_bounds__(Ring<F32Cfg>::THREADS)\n"
              "    ragged_dot_f32_tma(")
A_MAP_SWIZZLE = ("a_box, ones,\n        CU_TENSOR_MAP_INTERLEAVE_NONE, sw,")

HALF_WIDTH_STAGE = """\
template <int NH>
__device__ __forceinline__ void f32_stage(const float* As, int r_in, int c_in,
                                          float (&acc)[4][8]) {
    constexpr int BK = F32Cfg::BK, BN = F32Cfg::BN;
    const float* Bs = As + BM * BK;
#pragma unroll
    for (int k4 = 0; k4 < BK; k4 += 4) {
        float4 a[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
            a[i] = *reinterpret_cast<const float4*>(As + (r_in + i) * BK + k4);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            float bv[4 * NH];
#pragma unroll
            for (int h = 0; h < NH; ++h) {
                const float4 b = *reinterpret_cast<const float4*>(
                    Bs + (k4 + q) * BN + c_in + h * 64);
                bv[4 * h] = b.x;
                bv[4 * h + 1] = b.y;
                bv[4 * h + 2] = b.z;
                bv[4 * h + 3] = b.w;
            }
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const float av = q == 0   ? a[i].x
                                 : q == 1 ? a[i].y
                                 : q == 2 ? a[i].z
                                          : a[i].w;
#pragma unroll
                for (int j = 0; j < 4 * NH; ++j)
                    acc[i][j] = fmaf(av, bv[j], acc[i][j]);
            }
        }
    }
}

"""

# the consumer loop's head and tail, shared by the variants
HEAD = """\
    RingState r;
    for (;;) {
        mbar_wait(&full[r.s], r.phase);
        const Item it = meta[r.s];
        if (it.row0 >= it.row1) return;
        if (it.group < 0) {
            store_zero_rows<C>(out, it, N);
            release(&empty[r.s], lane);
            r.next();
            continue;
        }
"""
STAGE_LOOP = """\
        for (int kb = 0; kb < nkb; ++kb) {
            if (kb > 0) mbar_wait(&full[r.s], r.phase);
            const float* As = reinterpret_cast<const float*>(
                smem + r.s * R::STAGE_BYTES);
            const float* Bs = As + BM * C::BK;
            (void)Bs;
%s
            release(&empty[r.s], lane);
            r.next();
        }
"""

HALF_WIDTH = START + """\
    const int ty = lane >> 4, tx = lane & 15;
""" + HEAD + """\
        const bool narrow = it.row1 - it.row0 <= 32;
        const int r_in = (narrow ? warp >> 1 : warp) * 8 + ty * 4;
        const int c_in = tx * 4 + (narrow ? (warp & 1) * 64 : 0);
        const bool busy = r_in - ty * 4 < it.row1 - it.row0;
        float acc[4][8];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
""" + STAGE_LOOP % """\
            if (busy && narrow)
                f32_stage<1>(As, r_in, c_in, acc);
            else if (busy)
                f32_stage<2>(As, r_in, c_in, acc);""" + """\
        if (!busy) continue;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int row = it.row0 + r_in + i;
            if (row >= it.row1) continue;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int col = it.n0 + c_in + h * 64;
                if ((h == 0 || !narrow) && col < N)
                    *reinterpret_cast<float4*>(out + (size_t)row * N + col) =
                        make_float4(acc[i][4 * h], acc[i][4 * h + 1],
                                    acc[i][4 * h + 2], acc[i][4 * h + 3]);
            }
        }
    }
""" + END

COLUMN_SPLIT = START + """\
    const int ty = lane >> 2, c = warp * 16 + (lane & 3) * 4;
""" + HEAD + """\
        const int n8 = (it.row1 - it.row0 + 7) / 8;
        float acc[8][4];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
""" + STAGE_LOOP % """\
#pragma unroll
            for (int k4 = 0; k4 < C::BK; k4 += 4) {
                float4 b[4];
#pragma unroll
                for (int q = 0; q < 4; ++q)
                    b[q] = *reinterpret_cast<const float4*>(
                        Bs + (k4 + q) * C::BN + c);
                const int chunk = ((k4 >> 2) ^ ty) * 4;  // the swizzle
#pragma unroll
                for (int i = 0; i < 8; ++i) {
                    if (i >= n8) break;
                    const float4 a = *reinterpret_cast<const float4*>(
                        As + (ty + 8 * i) * C::BK + chunk);
                    const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
                    for (int q = 0; q < 4; ++q) {
                        acc[i][0] = fmaf(av[q], b[q].x, acc[i][0]);
                        acc[i][1] = fmaf(av[q], b[q].y, acc[i][1]);
                        acc[i][2] = fmaf(av[q], b[q].z, acc[i][2]);
                        acc[i][3] = fmaf(av[q], b[q].w, acc[i][3]);
                    }
                }
            }""" + """\
        const int col = it.n0 + c;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
            const int row = it.row0 + ty + 8 * i;
            if (row < it.row1 && col < N)
                *reinterpret_cast<float4*>(out + (size_t)row * N + col) =
                    make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
        }
    }
""" + END

TILE_8X8 = START + """\
    const int ty = lane >> 4, tx = lane & 15;
    const int r_in = warp * 16 + ty * 8;
""" + HEAD + """\
        const bool busy = warp * 16 < it.row1 - it.row0;
        float acc[8][8];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
""" + STAGE_LOOP % """\
            if (busy) {
#pragma unroll
                for (int k4 = 0; k4 < C::BK; k4 += 4) {
                    float4 a[8];
#pragma unroll
                    for (int i = 0; i < 8; ++i)
                        a[i] = *reinterpret_cast<const float4*>(
                            As + (r_in + i) * C::BK + k4);
#pragma unroll
                    for (int q = 0; q < 4; ++q) {
                        const float* brow = Bs + (k4 + q) * C::BN + tx * 4;
                        const float4 b0 =
                            *reinterpret_cast<const float4*>(brow);
                        const float4 b1 =
                            *reinterpret_cast<const float4*>(brow + 64);
                        const float bv[8] = {b0.x, b0.y, b0.z, b0.w,
                                             b1.x, b1.y, b1.z, b1.w};
#pragma unroll
                        for (int i = 0; i < 8; ++i) {
                            const float av = q == 0   ? a[i].x
                                             : q == 1 ? a[i].y
                                             : q == 2 ? a[i].z
                                                      : a[i].w;
#pragma unroll
                            for (int j = 0; j < 8; ++j)
                                acc[i][j] = fmaf(av, bv[j], acc[i][j]);
                        }
                    }
                }
            }""" + """\
        if (!busy) continue;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
            const int row = it.row0 + r_in + i;
            if (row >= it.row1) continue;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int col = it.n0 + h * 64 + tx * 4;
                if (col < N)
                    *reinterpret_cast<float4*>(out + (size_t)row * N + col) =
                        make_float4(acc[i][4 * h], acc[i][4 * h + 1],
                                    acc[i][4 * h + 2], acc[i][4 * h + 3]);
            }
        }
    }
""" + END


def _edit(src: str, old: str, new: str) -> str:
    if old not in src:
        raise RuntimeError(f"k6_variants: {old[:60]!r} is not in the source")
    return src.replace(old, new)


def variant_sources(src: str) -> dict:
    """name -> (source, the dtypes it changes)."""
    a, b = src.index(START), src.index(END) + len(END)

    def consumers(block):
        return src[:a] + block + src[b:]

    both, f32 = ("float32", "bfloat16"), ("float32",)
    return {
        "ring3": (_edit(src, STAGES, "constexpr int STAGES = 3;"), both),
        "ring6": (_edit(src, STAGES, "constexpr int STAGES = 6;"), both),
        "half_width": (_edit(consumers(HALF_WIDTH), F32_KERNEL,
                             HALF_WIDTH_STAGE + F32_KERNEL), f32),
        "column_split": (_edit(consumers(COLUMN_SPLIT), A_MAP_SWIZZLE,
                               A_MAP_SWIZZLE.replace(
                                   " sw,", " CU_TENSOR_MAP_SWIZZLE_128B,")),
                         f32),
        "tile_8x8": (_edit(consumers(TILE_8X8),
                           "static constexpr int CONSUMER_WARPS = 8;",
                           "static constexpr int CONSUMER_WARPS = 4;"), f32),
    }


def build_variants(build, sources: dict) -> dict:
    """Compile each variant into its own library (all at once); name ->
    its ``ragged_dot_launch``."""
    WORK.mkdir(parents=True, exist_ok=True)
    jobs = []
    for name, (src, _) in sources.items():
        cu, so = WORK / f"{name}.cu", WORK / f"{name}.so"
        cu.write_text(src)
        jobs.append((name, so, subprocess.Popen(
            [build._nvcc(), *build.COMPILE_FLAGS, "-shared", "-I",
             str(build.CSRC), str(cu), "-o", str(so), *build.LINK_FLAGS],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    fns = {}
    for name, so, proc in jobs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{out}")
        kernel = None  # the TMA kernels' registers and spills
        for line in out.splitlines():
            if "Compiling entry" in line:
                kernel = next((kn for kn in ("f32_tma", "bf16_tma")
                               if kn in line), None)
            elif kernel and ("registers" in line or "spill" in line):
                print(f"{name} {kernel}: {line.strip()}", flush=True)
        fn = ctypes.CDLL(str(so)).ragged_dot_launch
        fn.argtypes = build.SIGNATURES["ragged_dot_launch"]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, default=WORK / "summary.json")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    if not torch.cuda.is_available():
        print("k6_variants: no CUDA device available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels.ragged_dot import ragged_dot

    build.library()
    sources = variant_sources(SOURCE.read_text())
    fns = build_variants(build, sources)
    shapes = dict(cs.K6_SHAPES, empty=(1000, 256, 192, 40))
    summary = {"card": cs.card_line(), "ms": {}}
    for case, (m, k, n, g) in shapes.items():
        for dtype in (torch.float32, torch.bfloat16):
            dt = str(dtype)[6:]
            lhs, rhs, sizes = cs.k6_inputs(torch, m, k, n, g, dtype, 17,
                                           empty=case == "empty")
            ref = ragged_dot(lhs, rhs, sizes)
            calls = {"committed": lambda: ragged_dot(lhs, rhs, sizes)}
            for name, fn in fns.items():
                if dt not in sources[name][1]:
                    continue
                out = torch.empty_like(ref)

                def launch(fn=fn, out=out):
                    build.check(fn(
                        lhs.data_ptr(), rhs.data_ptr(), sizes.data_ptr(),
                        out.data_ptr(), m, k, n, g,
                        int(dtype == torch.bfloat16), 1, 0,
                        torch.cuda.current_stream().cuda_stream), name)

                launch()
                torch.cuda.synchronize()
                cs.require(torch.equal(out, ref),
                           f"k6_variants: {name} differs from the committed "
                           f"kernel at {case} {dt}")
                calls[name] = launch
            order = list(calls)
            times = {name: [] for name in order}
            for rnd in (order, order[::-1]):
                for name in rnd:
                    times[name].append(cs.device_ms(torch, calls[name], 20))
            summary["ms"][f"{case} {dt}"] = times
            print(f"{case} {dt}: {json.dumps(times)}", flush=True)
            del lhs, rhs, sizes, ref, calls
            torch.cuda.empty_cache()
    print(summary["card"], flush=True)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(summary, indent=1))
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
