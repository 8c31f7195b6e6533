"""Build variants of the face-form fused_step_cm kernel and time them side
by side on one CUDA card: the tuning behind csrc/stencil.cu's
kFaceRunRows (the longest run of rows a warp walks) and kFaceMinBlocks
(the register cap: blocks that must fit an SM).

    python scripts/torch_face_variants.py [--variants 8:6 4:6 16:6 8:0 8:8] [--json PATH]

Each variant `R:B` is the kernel built from this checkout's
csrc/stencil.cu with kFaceRunRows = R and kFaceMinBlocks = B (0: no cap),
one nvcc each, all started together, into .chip_scratch/face_variants/
(git-ignored). Every variant runs the whole core of a 6144² shard (a rank
of 2×2 of 12288²) in f32, bf16 and f64 and of a 128³ shard in f32, from
the shard and contiguous faces as the sharded steps launch it, each held
bitwise against fused_step_cm_plain first; its figure is the device ms a
launch of 200 queued behind torch.cuda._sleep between two CUDA events,
in two rounds, beside masked_step on the same shard (the one-GPU layout
this kernel takes). The card's name and power limit head the output.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
RUN = "constexpr int kFaceRunRows = 8;"
CAP = "constexpr int kFaceMinBlocks = 6;"
LAUNCH = ("__global__ void __launch_bounds__(kMsWarps * 32, kFaceMinBlocks)\n"
          "rmt_fused_step_cm_kernel")
# What build() rewrites in csrc/stencil.cu (a test holds them there).
MARKERS = (RUN, CAP, LAUNCH)
CASES = (((6144, 6144), ("f32", "bf16", "f64")), ((128, 128, 128), ("f32",)))
CALLS = 200


def build(variants):
    """{name: ctypes function} of every variant, built in parallel."""
    sys.path.insert(0, str(ROOT))
    from rocm_mpi_tpu_torch.ops import _build, kernels

    src = (ROOT / "rocm_mpi_tpu_torch/csrc/stencil.cu").read_text()
    for marker in MARKERS:
        if marker not in src:
            raise SystemExit(f"csrc/stencil.cu no longer holds {marker!r}: update this script")
    out = ROOT / ".chip_scratch" / "face_variants"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in variants:
        rows, cap = (int(x) for x in name.split(":"))
        text = src.replace(RUN, f"constexpr int kFaceRunRows = {rows};")
        text = text.replace(CAP, f"constexpr int kFaceMinBlocks = {cap};")
        if cap == 0:
            text = text.replace(LAUNCH, LAUNCH.replace(", kFaceMinBlocks", ""))
        tag = name.replace(":", "_")
        (out / f"{tag}.cu").write_text(text)
        cmd = [_build.nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o",
               str(out / f"lib{tag}.so"), str(out / f"{tag}.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    fns = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for variant {name}:\n{log}")
        fn = ctypes.CDLL(str(out / f"lib{name.replace(':', '_')}.so")).rmt_fused_step_cm
        fn.restype, fn.argtypes = kernels._SIGNATURES["rmt_fused_step_cm"]
        fns[name] = fn
    return fns


def loop_ms(torch, fn) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(0.02 * 2e9))  # holds the card while the host enqueues
    start.record()
    for _ in range(CALLS):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / CALLS


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--variants", nargs="+", default=["8:6", "4:6", "16:6", "8:0", "8:8"],
                        help="kFaceRunRows:kFaceMinBlocks of each build (0: no cap)")
    parser.add_argument("--json", help="write the results here")
    args = parser.parse_args()
    import torch

    from rocm_mpi_tpu_torch.apps._common import card_line
    from rocm_mpi_tpu_torch.ops import kernels as K

    fns = build(args.variants)
    card = card_line()
    print(f"[variants] card: {card}", flush=True)
    dev = torch.device("cuda", 0)
    dtypes = {"f32": torch.float32, "bf16": torch.bfloat16, "f64": torch.float64}
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = []
    for shape, names in CASES:
        spacing = (0.1,) * len(shape)
        for dn in names:
            dt = dtypes[dn]
            Tp = torch.rand(tuple(n + 2 for n in shape), generator=gen, device=dev,
                            dtype=torch.float64).to(dt)
            Cm = (torch.rand(shape, generator=gen, device=dev, dtype=torch.float64)
                  * 1e-3).to(dt)
            out = torch.empty(shape, dtype=dt, device=dev)
            T = Tp[tuple(slice(1, -1) for _ in shape)].contiguous()
            faces = tuple(f.clone(memory_format=torch.contiguous_format)
                          for f in K.face_views(Tp)[1])
            want = K.fused_step_cm_plain(Tp, Cm, K.inv_d2_of(spacing))
            strides, ptrs, fstr = K._face_args(T, faces)
            vec = K.face_layout(T, faces, Cm, out)
            fargs = (K._DTYPE_CODE[dt], T.ndim, T.data_ptr(), strides, ptrs, fstr,
                     Cm.data_ptr(), out.data_ptr(), *K.extents(shape),
                     *K.box_args(K.core_box(shape)), *K.inv3(K.inv_d2_of(spacing)), vec,
                     torch.cuda.current_stream().cuda_stream)
            row = {"shape": list(shape), "dtype": dn, "vec": vec, "ms": {}}
            for _ in range(2):
                for name, fn in fns.items():
                    out.zero_()
                    if fn(*fargs) != 0:
                        raise SystemExit(f"variant {name}: launch failed")
                    torch.cuda.synchronize()
                    if not torch.equal(out, want):
                        raise SystemExit(f"variant {name} {shape} {dn}: != the plain version")
                    row["ms"].setdefault(name, []).append(loop_ms(torch, lambda: fn(*fargs)))
            row["masked_step_ms"] = loop_ms(
                torch, lambda: K.masked_step(T, Cm, spacing, out=out))
            rows.append(row)
            print(f"[variants] {'x'.join(map(str, shape))} {dn} (vectors {vec}), ms a launch "
                  f"(two rounds): masked_step {row['masked_step_ms']:.4f} | " + ", ".join(
                      f"{n} {' / '.join(f'{t:.4f}' for t in ts)}"
                      for n, ts in row["ms"].items()) + f" on {card}", flush=True)
            del Tp, Cm, out, T, faces, want
            torch.cuda.empty_cache()
    if args.json:
        pathlib.Path(args.json).write_text(json.dumps({"card": card, "rows": rows}, indent=1))
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    sys.exit(main())
