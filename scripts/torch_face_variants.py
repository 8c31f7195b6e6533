"""Build variants of the face-form fused_step_cm kernel and time them side
by side on one CUDA card: the tuning behind csrc/stencil.cu's shared face
kernel (kFaceRunRows, the longest run of rows a warp walks, and
kFaceMinBlocks, the register cap: blocks that must fit an SM) and behind
its f64 route (kF64Cells2 and kF64Cells3, a lane's cells of a row in 2D
and 3D, kF64RunRows, and an optional register cap).

    python scripts/torch_face_variants.py [--variants shared:8:6 f64:4:2:3:0 ...]
                                          [--cases hide whole 3d] [--json PATH]

A variant is built from this checkout's csrc/stencil.cu with its marked
lines rewritten (MARKERS), one nvcc each with `-Xptxas -v`, all started
together, into .chip_scratch/face_variants/ (git-ignored):

- `shared:R:B`: every dtype through the shared kernel, f64 too (the f64
  route switched off), with kFaceRunRows = R and kFaceMinBlocks = B (0: no
  cap); `shared:8:6` is the kernel every f64 launch took before the route;
- `f64:C2:C3:R:B`: the checkout's shared kernel for f32 and bf16, and the
  f64 route with kF64Cells2 = C2 (2D) and kF64Cells3 = C3 (3D) cells a
  lane, kF64RunRows = R and at least B blocks an SM (0: no cap);
  `f64:4:2:3:0` is the checkout's route.

Cases (`--cases`): `hide`, the benchmark's hide cell's rank in f64: a
12288² shard with b_width (32, 4), each of its five boxes launched alone
and the five together, from the shard and fresh face buffers as the
overlap step launches them, masked_step on the same shard beside; `whole`,
the whole core of a 6144² shard (a rank of 2×2 of 12288², the sharded
perf step's launch) in f32, bf16 and f64; `3d`, a 128³ shard in f64 and
f32, whole and as its seven (8, 8, 8) hide boxes. Every launch is held
bitwise against fused_step_cm_plain over the box first; its figure is the
device ms a call of CALLS calls queued behind torch.cuda._sleep between
two CUDA events, in two rounds. Each variant's registers and spills
(ptxas) for the fused_step_cm kernels, and the card's name and power
limit, head the output.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
RUN = "constexpr int kFaceRunRows = 8;"
CAP = "constexpr int kFaceMinBlocks = 6;"
LAUNCH = ("__global__ void __launch_bounds__(kMsWarps * 32, kFaceMinBlocks)\n"
          "rmt_fused_step_cm_kernel")
F64_CELLS2 = "constexpr int kF64Cells2 = 4;"
F64_CELLS3 = "constexpr int kF64Cells3 = 2;"
F64_RUN = "constexpr int kF64RunRows = 3;"
F64_LAUNCH = ("__global__ void __launch_bounds__(kMsWarps * 32)\n"
              "rmt_fused_step_cm_f64_kernel")
F64_ROUTE = "if constexpr (std::is_same_v<S, double>) {  // f64: its own route"
# What build() rewrites in csrc/stencil.cu (a test holds them there).
MARKERS = (RUN, CAP, LAUNCH, F64_CELLS2, F64_CELLS3, F64_RUN, F64_LAUNCH, F64_ROUTE)
CASES = ("hide", "whole", "3d")
HIDE_SHAPE, HIDE_B_WIDTH = (12288, 12288), (32, 4)
CALLS = 200


def variant_source(src: str, name: str) -> str:
    """csrc/stencil.cu rewritten for variant `name` (module docstring)."""
    kind, *nums = name.split(":")
    nums = [int(x) for x in nums]
    if kind == "shared" and len(nums) == 2:
        rows, cap = nums
        text = src.replace(RUN, f"constexpr int kFaceRunRows = {rows};")
        text = text.replace(CAP, f"constexpr int kFaceMinBlocks = {cap};")
        if cap == 0:
            text = text.replace(LAUNCH, LAUNCH.replace(", kFaceMinBlocks", ""))
        return text.replace(F64_ROUTE, "if constexpr (false) {")
    if kind == "f64" and len(nums) == 4:
        cells2, cells3, rows, cap = nums
        text = src.replace(F64_CELLS2, f"constexpr int kF64Cells2 = {cells2};")
        text = text.replace(F64_CELLS3, f"constexpr int kF64Cells3 = {cells3};")
        text = text.replace(F64_RUN, f"constexpr int kF64RunRows = {rows};")
        if cap:
            text = text.replace(F64_LAUNCH, F64_LAUNCH.replace("32)", f"32, {cap})"))
        return text
    raise SystemExit(f"variant {name!r}: expected shared:R:B or f64:C2:C3:R:B")


def ptxas_lines(log: str) -> list[str]:
    """ptxas's register and spill lines of the fused_step_cm kernels and of
    masked_step's f64 one (the level the f64 route is held to)."""
    out, entry = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
            keep = "fused_step_cm" in name or "masked_step_kernelId" in name
            entry = name[name.index("rmt_"):] if keep else None
        elif entry and ("registers" in line or "spill" in line):
            out.append(f"{entry}: {line.split('ptxas info    :')[-1].strip()}")
    return out


def build(variants):
    """{name: (ctypes library, ptxas lines)} of every variant, built in
    parallel."""
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
        tag = name.replace(":", "_")
        (out / f"{tag}.cu").write_text(variant_source(src, name))
        cmd = [_build.nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-I", str(_build.CSRC),
               "-o", str(out / f"lib{tag}.so"), str(out / f"{tag}.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    built = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for variant {name}:\n{log}")
        lib = ctypes.CDLL(str(out / f"lib{name.replace(':', '_')}.so"))
        for symbol in ("rmt_fused_step_cm", "rmt_masked_step"):
            fn = getattr(lib, symbol)
            fn.restype, fn.argtypes = kernels._SIGNATURES[symbol]
        built[name] = (lib, ptxas_lines(log))
    return built


def loop_ms(torch, fn) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(0.05 * 2e9))  # holds the card while the host enqueues
    start.record()
    for _ in range(CALLS):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / CALLS


def shard(torch, K, shape, dt, dev, gen):
    """(T, fresh faces, Cm, out, want) of a shard: want is
    fused_step_cm_plain over the whole core."""
    Tp = torch.rand(tuple(n + 2 for n in shape), generator=gen, device=dev,
                    dtype=torch.float64).to(dt)
    Cm = (torch.rand(shape, generator=gen, device=dev, dtype=torch.float64) * 1e-3).to(dt)
    spacing = (0.1, 0.07, 0.05)[:len(shape)]
    want = K.fused_step_cm_plain(Tp, Cm, K.inv_d2_of(spacing))
    T = Tp[tuple(slice(1, -1) for _ in shape)].contiguous()
    # Fresh buffers, as the face exchange's (a view of a size-1 axis would
    # count as contiguous and sit off the 16-byte grid).
    faces = tuple(f.clone(memory_format=torch.contiguous_format) for f in K.face_views(Tp)[1])
    del Tp
    return T, faces, Cm, torch.empty(shape, dtype=dt, device=dev), want, spacing


def launches(torch, K, fn, T, faces, Cm, out, spacing, boxes, free):
    """A function that launches `fn` (a variant's rmt_fused_step_cm) over
    `boxes` (the ghost-free ones, `free`, with no faces, as the overlap
    step's interior)."""
    stream = torch.cuda.current_stream().cuda_stream
    none = (None,) * len(faces)
    calls = []
    for box in boxes:
        fc = none if free(box) else faces
        strides, ptrs, fstr = K._face_args(T, fc)
        args = (K._DTYPE_CODE[T.dtype], T.ndim, T.data_ptr(), strides, ptrs, fstr,
                Cm.data_ptr(), out.data_ptr(), *K.extents(T.shape), *K.box_args(box),
                *K.inv3(K.inv_d2_of(spacing)), K.face_layout(T, fc, Cm, out), stream)
        calls.append((args, strides, ptrs, fstr))

    def run():
        for args, *_ in calls:
            if fn(*args) != 0:
                raise SystemExit("launch failed")
    return run


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--variants", nargs="+",
                        default=["shared:8:6", "f64:4:2:3:0", "f64:4:2:4:0", "f64:2:2:3:0"],
                        help="shared:R:B or f64:C2:C3:R:B (module docstring)")
    parser.add_argument("--cases", nargs="+", choices=CASES, default=list(CASES))
    parser.add_argument("--json", help="write the results here")
    args = parser.parse_args()
    import torch

    from rocm_mpi_tpu_torch.apps._common import card_line
    from rocm_mpi_tpu_torch.ops import kernels as K
    from rocm_mpi_tpu_torch.parallel import overlap

    built = build(args.variants)
    card = card_line()
    print(f"[variants] card: {card}", flush=True)
    for name, (_, lines) in built.items():
        for line in lines:
            print(f"[variants] {name} ptxas {line}", flush=True)
    dev = torch.device("cuda", 0)
    dtypes = {"f32": torch.float32, "bf16": torch.bfloat16, "f64": torch.float64}
    gen = torch.Generator(device=dev).manual_seed(0)
    plan = []  # (shape, dtype name, b_width or None)
    if "hide" in args.cases:
        plan.append((HIDE_SHAPE, "f64", HIDE_B_WIDTH))
    if "whole" in args.cases:
        plan += [((6144, 6144), dn, None) for dn in ("f32", "bf16", "f64")]
    if "3d" in args.cases:
        plan += [((128, 128, 128), dn, (8, 8, 8)) for dn in ("f64", "f32")]
    rows = []
    for shape, dn, bw in plan:
        T, faces, Cm, out, want, spacing = shard(torch, K, shape, dtypes[dn], dev, gen)
        free = (lambda b: overlap.ghost_free(b, shape)) if bw else (lambda b: False)
        whole = [K.core_box(shape)]
        groups = {"whole": whole}
        if bw:
            boxes = overlap.region_boxes(shape, overlap.effective_b_width(shape, bw))
            groups = {"boxes": boxes, **{f"box {b}": [b] for b in boxes}}
            if dn == "f64" and len(shape) == 3:
                groups["whole"] = whole
        label = "x".join(map(str, shape))
        for group, boxes in groups.items():
            row = {"shape": list(shape), "dtype": dn, "case": group, "ms": {}}
            for _ in range(2):
                for name, (lib, _) in built.items():
                    run = launches(torch, K, lib.rmt_fused_step_cm, T, faces, Cm, out, spacing,
                                   boxes, free)
                    out.fill_(float("nan"))
                    run()
                    torch.cuda.synchronize()
                    for box in boxes:
                        sl = tuple(slice(lo, hi) for lo, hi in box)
                        if not torch.equal(out[sl], want[sl]):
                            raise SystemExit(f"variant {name} {label} {dn} {group}: "
                                             f"!= the plain version in box {box}")
                    row["ms"].setdefault(name, []).append(loop_ms(torch, run))
            if group in ("whole", "boxes") and len(shape) == 2 and dn == "f64":
                # masked_step (the same source in every variant) on the shard
                masked = next(iter(built.values()))[0].rmt_masked_step
                margs = (K._DTYPE_CODE[T.dtype], 2, T.data_ptr(), Cm.data_ptr(), out.data_ptr(),
                         *K.extents(shape), *K.inv3(K.inv_d2_of(spacing)), 0, 0,
                         torch.cuda.current_stream().cuda_stream)
                row["masked_step_ms"] = loop_ms(torch, lambda: masked(*margs))
            rows.append(row)
            beside = (f"masked_step {row['masked_step_ms']:.4f} | "
                      if "masked_step_ms" in row else "")
            print(f"[variants] {label} {dn} {group}, ms a launch set (two rounds): {beside}"
                  + ", ".join(f"{n} {' / '.join(f'{t:.4f}' for t in ts)}"
                              for n, ts in row["ms"].items()) + f" on {card}", flush=True)
        del T, faces, Cm, out, want
        torch.cuda.empty_cache()
    if args.json:
        pathlib.Path(args.json).write_text(json.dumps(
            {"card": card, "ptxas": {n: lines for n, (_, lines) in built.items()},
             "rows": rows}, indent=1))
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    sys.exit(main())
