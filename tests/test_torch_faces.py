"""The face form of fused_step_cm and the face exchange of the sharded
diffusion steps (rocm_mpi_tpu_torch/ops/kernels.py `fused_step_cm_faces`,
rocm_mpi_tpu_torch/parallel/halo.py `exchange_faces`) against the JAX
package on the CPU:

* the face form's plain version — what a CPU tensor runs, and what
  chip_smoke.py holds the CUDA kernel against — against JAX's Pallas
  `fused_step_cm` (interpret mode, as the JAX package's tests run it) on
  the padded block assembled from the same core and faces, zeros where a
  face is None (a domain edge): whole and per `hide` box, 2D and 3D;
* the wrapper's contract: the views it takes of a padded block, its
  checks, its layout rule, and no launch counted on the CPU;
* the f64 route (csrc/stencil.cu rmt_fused_step_cm_f64_kernel): every
  f64 launch and no f32 or bf16 one counted in F64_ROUTE_LAUNCHES, and
  its cut (segments as narrow as the box, strips on their own grid) in
  plain PyTorch, bitwise the plain version whole and box by box;
* on 4 gloo ranks (tests/test_torch_faces_worker.py): every face of
  `exchange_faces` equal to the matching ghost of `exchange_halo`'s
  padded buffer (2×2 and 2×2×1, f32 and bf16 wire), one batch a call,
  the same buffers every call; then the sharded `perf` and `hide` runs
  (2D and 3D, both drivers, three dtypes, both wires) bitwise equal to the
  same steps over the padded route, and against the JAX package's
  sharded runs as tests/test_torch_overlap.py holds them.

Bitwise against JAX in f32 and f64: the JAX reference is compiled with
XLA's backend optimisation off (`xla_backend_optimization_level` 0), so
that XLA:CPU keeps each multiply and add rounded as written, as the plain
version and the CUDA kernel (built with -fmad=false) do; at the default
level LLVM reassociates and contracts some of them, and the two differ
by an ulp on some cells. bf16 within one bf16 ulp of the stored value.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rocm_mpi_tpu.ops.pallas_kernels as pk
import test_torch_faces_worker as worker
from rocm_mpi_tpu.config import DiffusionConfig as JaxConfig
from rocm_mpi_tpu.models import HeatDiffusion as JaxHeatDiffusion
from rocm_mpi_tpu_torch.ops import kernels as K
from rocm_mpi_tpu_torch.parallel import overlap
from rocm_mpi_tpu_torch.parallel.launcher import spawn_ranks
from rocm_mpi_tpu_torch.state import tensor_from_numpy

NP = {"f64": np.float64, "f32": np.float32}
SPACING = {2: (0.1, 0.07), 3: (0.3, 0.4, 0.5)}
SHAPES = [(63, 50), (24, 16), (12, 10, 8), (7, 9, 6)]
# Which faces a case gives: every one (an interior rank), or None on the
# low side of every axis (a rank at the domain's low corner), or none.
FACE_SETS = ("all", "low-edges", "none")
# The JAX package's two fused_step_cm routes: whole-block in VMEM, and the
# 3-slot striped kernel (budget shrunk so a small block takes it).
ROUTES = {"vmem": None, "striped": 1024}
NPROCS = 4
TOL = {"f64": dict(rtol=1e-12, atol=1e-14), "f32": dict(rtol=2e-5, atol=2e-6)}


def _inputs(shape, dtype, faces_set, seed=0):
    """T, the 2·ndim faces (numpy, None where absent) and Cm."""
    rng = np.random.default_rng(seed)
    T = rng.random(shape).astype(dtype)
    faces = []
    for k in range(2 * len(shape)):
        absent = faces_set == "none" or (faces_set == "low-edges" and k % 2 == 0)
        fshape = tuple(1 if a == k // 2 else n for a, n in enumerate(shape))
        faces.append(None if absent else rng.random(fshape).astype(dtype))
    Cm = (rng.random(shape) * 1e-3).astype(dtype)
    return T, faces, Cm


def _padded(T, faces):
    """The width-1-padded block of T and its faces, zeros where absent."""
    Tp = np.zeros(tuple(n + 2 for n in T.shape), dtype=T.dtype)
    Tp[tuple(slice(1, -1) for _ in T.shape)] = T
    for sl, f in zip(K.ghost_slices(T.ndim), faces):
        if f is not None:
            Tp[sl] = f
    return Tp


def _jax_fused(Tp, Cm, spacing):
    """JAX's fused_step_cm, compiled with the backend's optimisation off
    (module docstring)."""
    fn = jax.jit(functools.partial(pk.fused_step_cm, spacing=spacing))
    args = (jnp.asarray(Tp), jnp.asarray(Cm))
    return np.asarray(fn.lower(*args).compile({"xla_backend_optimization_level": 0})(*args))


def _torch_faces(T, faces, Cm, spacing, box=None, out=None):
    tf = tuple(None if f is None else torch.from_numpy(f) for f in faces)
    return K.fused_step_cm_faces(torch.from_numpy(T), tf, torch.from_numpy(Cm), spacing,
                                 box=box, out=out)


# ---------------------------------------------------------------------------
# The face form's plain version against JAX
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("route", sorted(ROUTES))
@pytest.mark.parametrize("faces_set", FACE_SETS)
@pytest.mark.parametrize("dtype", ["f64", "f32"])
@pytest.mark.parametrize("shape", SHAPES)
def test_face_form_matches_pallas_bitwise(shape, dtype, faces_set, route, monkeypatch):
    if ROUTES[route] is not None:
        monkeypatch.setattr(pk, "_VMEM_BLOCK_BUDGET_BYTES", ROUTES[route])
    T, faces, Cm = _inputs(shape, NP[dtype], faces_set)
    sp = SPACING[len(shape)]
    got = _torch_faces(T, faces, Cm, sp).numpy()
    np.testing.assert_array_equal(got, _jax_fused(_padded(T, faces), Cm, sp))


@pytest.mark.parametrize("faces_set", ["all", "low-edges"])
@pytest.mark.parametrize("dtype", ["f64", "f32"])
@pytest.mark.parametrize("shape,bw", [((24, 20), (4, 3)), ((24, 20), (32, 4)),
                                      ((12, 10, 8), (3, 2, 2)), ((12, 10, 8), (8, 8, 128))])
def test_face_form_hide_boxes_match_pallas_bitwise(shape, bw, dtype, faces_set):
    # Each box of the overlap decomposition, from the core and the faces
    # (the interior with none, as the hide step launches it), against JAX's
    # fused_step_cm on that box's window of the assembled block.
    T, faces, Cm = _inputs(shape, NP[dtype], faces_set, seed=1)
    sp = SPACING[len(shape)]
    Tp = _padded(T, faces)
    boxes = overlap.region_boxes(shape, overlap.effective_b_width(shape, bw))
    out = torch.full(shape, float("nan"), dtype=torch.from_numpy(T).dtype)
    none = (None,) * (2 * len(shape))
    for box in boxes:
        _torch_faces(T, none if overlap.ghost_free(box, shape) else faces, Cm, sp, box=box,
                     out=out)
        window, sl = K.region_slices(box, 1)
        np.testing.assert_array_equal(out[sl].numpy(), _jax_fused(Tp[window], Cm[sl], sp))
    assert not torch.isnan(out).any()  # the boxes cover the core


@pytest.mark.parametrize("faces_set", ["all", "low-edges"])
@pytest.mark.parametrize("shape", [(40, 24), (12, 10, 8)])
def test_face_form_bf16_within_one_ulp(shape, faces_set):
    # bf16 storage, f32 arithmetic, one rounding on store: within one bf16
    # ulp of JAX's stored value (bit for bit on these inputs).
    T, faces, Cm = _inputs(shape, np.float32, faces_set, seed=2)
    bf = lambda a: None if a is None else jnp.asarray(a, dtype=jnp.bfloat16)  # noqa: E731
    Tb, Cmb = bf(T), bf(Cm)
    fb = [bf(f) for f in faces]
    to_t = lambda a: None if a is None else tensor_from_numpy(np.asarray(a))  # noqa: E731
    got = K.fused_step_cm_faces(to_t(Tb), tuple(to_t(f) for f in fb), to_t(Cmb),
                                SPACING[len(shape)])
    assert got.dtype == torch.bfloat16
    Tp = _padded(np.asarray(Tb).astype(np.float32),
                 [None if f is None else np.asarray(f).astype(np.float32) for f in fb])
    ref = np.asarray(pk.fused_step_cm(jnp.asarray(Tp, dtype=jnp.bfloat16), Cmb,
                                      SPACING[len(shape)])).astype(np.float32)
    g = got.float().numpy()
    ulp = np.spacing(np.abs(ref).astype(np.float32)) * 2.0 ** 16  # bf16 keeps 8 of f32's 24 bits
    assert np.all(np.abs(g - ref) <= ulp)


# ---------------------------------------------------------------------------
# The wrapper's contract
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(6, 5), (4, 5, 6)])
def test_face_views_are_the_padded_block(shape):
    Tp = torch.arange(float(np.prod([n + 2 for n in shape]))).reshape([n + 2 for n in shape])
    T, faces = K.face_views(Tp)
    assert len(faces) == 2 * len(shape)
    for k, f in enumerate(faces):
        assert f.shape == tuple(1 if a == k // 2 else n for a, n in enumerate(shape))
        # views, not copies
        assert f.untyped_storage().data_ptr() == Tp.untyped_storage().data_ptr()
    # The block back from its views: every cell but the corners (which no
    # 5- or 7-point stencil reads), and the corners zero.
    back = K.assemble_padded(T, faces)
    lost = torch.ones_like(Tp, dtype=torch.bool)
    lost[tuple(slice(1, -1) for _ in shape)] = False
    for sl in K.ghost_slices(len(shape)):
        lost[sl] = False
    assert torch.equal(back[~lost], Tp[~lost]) and not back[lost].any()


@pytest.mark.parametrize("shape", [(24, 16), (12, 10, 8)])
def test_padded_call_is_the_face_form_on_its_views(shape):
    rng = np.random.default_rng(4)
    Tp = torch.from_numpy(rng.random(tuple(n + 2 for n in shape)))
    Cm = torch.from_numpy(rng.random(shape) * 1e-3)
    sp = SPACING[len(shape)]
    T, faces = K.face_views(Tp)
    assert torch.equal(K.fused_step_cm(Tp, Cm, sp), K.fused_step_cm_faces(T, faces, Cm, sp))
    # The region form reads the same: a slab from the block, the interior
    # from the raw shard.
    box = tuple((0, 3) if a == 0 else (0, n) for a, n in enumerate(shape))
    inner = tuple((1, n - 1) for n in shape)
    for b, src, off in ((box, Tp, 1), (inner, T.contiguous(), 0)):
        got = torch.zeros(shape, dtype=torch.float64)
        K.fused_step_cm_region(src, off, Cm, sp, b, got)
        want = K.fused_step_cm_faces(T, faces, Cm, sp, box=b, out=torch.zeros_like(got))
        assert torch.equal(got, want)


def test_face_form_checks():
    T = torch.rand(8, 6)
    Cm = torch.rand(8, 6)
    faces = (torch.rand(1, 6), torch.rand(1, 6), torch.rand(8, 1), torch.rand(8, 1))
    sp = SPACING[2]
    K.fused_step_cm_faces(T, faces, Cm, sp)
    with pytest.raises(ValueError, match="4 faces|2 faces|faces for a 2D"):
        K.fused_step_cm_faces(T, faces[:2], Cm, sp)
    with pytest.raises(ValueError, match="face 2 shape"):
        K.fused_step_cm_faces(T, (faces[0], faces[1], torch.rand(8, 2), faces[3]), Cm, sp)
    with pytest.raises(TypeError, match="face 0"):
        K.fused_step_cm_faces(T, (faces[0].double(),) + faces[1:], Cm, sp)
    with pytest.raises(ValueError, match="last axis must be contiguous"):
        K.fused_step_cm_faces(T, (torch.rand(1, 12)[:, ::2],) + faces[1:], Cm, sp)
    with pytest.raises(ValueError, match="T's last axis"):
        K.fused_step_cm_faces(torch.rand(6, 8).t(), faces, Cm, sp)
    with pytest.raises(ValueError, match="alias"):
        K.fused_step_cm_faces(T, faces, Cm, sp, out=T)
    with pytest.raises(ValueError, match="alias"):  # a strided face inside out's span
        big = torch.zeros(8, 6)
        K.fused_step_cm_faces(T, faces[:2] + (big[:, 5:6], faces[3]), Cm, sp, out=big)
    with pytest.raises(ValueError, match="outside the core"):
        K.fused_step_cm_faces(T, faces, Cm, sp, box=((0, 9), (0, 6)), out=torch.empty(8, 6))
    with pytest.raises(ValueError, match="Cm must be contiguous"):
        K.fused_step_cm_faces(T, faces, Cm[:, :5], sp)


def test_face_layout_rule():
    # 16-byte vectors for f32 and bf16 on the 16-byte grid; scalar cells for
    # f64, a ragged last axis, and the padded caller's core (one cell in).
    for dtype, want in ((torch.float32, True), (torch.bfloat16, True),
                        (torch.float64, False)):
        T, Cm, out = (torch.zeros(16, 64, dtype=dtype) for _ in range(3))
        faces = (torch.zeros(1, 64, dtype=dtype),) * 2 + (torch.zeros(16, 1, dtype=dtype),) * 2
        assert K.face_layout(T, faces, Cm, out) is want
    T, Cm, out = (torch.zeros(16, 62) for _ in range(3))
    assert not K.face_layout(T, (None,) * 4, Cm, out)
    Tp = torch.zeros(18, 66)
    core, faces = K.face_views(Tp)
    assert not K.face_layout(core, faces, torch.zeros(16, 64), torch.zeros(16, 64))
    # 3D: the axis-0 and axis-1 faces are read as rows too.
    T3, Cm3, out3 = (torch.zeros(4, 6, 8) for _ in range(3))
    rows = (torch.zeros(1, 6, 8),) * 2 + (torch.zeros(4, 1, 8),) * 2
    assert K.face_layout(T3, rows + (torch.zeros(4, 6, 1),) * 2, Cm3, out3)
    odd = torch.zeros(1, 6, 9)[..., :8]  # row stride 9: off the grid
    assert not K.face_layout(T3, (odd,) + rows[1:] + (None, None), Cm3, out3)


def test_cpu_face_calls_do_not_count_launches():
    K.reset_launches()
    T, faces, Cm = _inputs((16, 12), np.float64, "all")
    _torch_faces(T, faces, Cm, SPACING[2])
    assert set(K.LAUNCHES.values()) == {0}
    assert K.F64_ROUTE_LAUNCHES == 0


# (shard, hide b_width): the hide cell's cut at a small size (a 32-row
# frame, 4-column slabs), a ragged last axis, and 3D's seven boxes.
ROUTE_CASES = [((80, 72), (32, 4)), ((37, 29), (8, 4)), ((12, 10, 8), (2, 2, 2))]


@pytest.mark.parametrize("case", range(len(ROUTE_CASES)))
@pytest.mark.parametrize("dtype", ["f64", "f32", "bf16"])
def test_f64_route_is_chosen_by_dtype_alone(dtype, case, monkeypatch):
    # With the dispatch forced to the kernel path on CPU tensors, every f64
    # launch (the whole shard and each hide box) counts as taking the f64
    # route, and no f32 or bf16 launch does; the launch hands the kernel the
    # dtype code its C switch routes on.
    shape, bw = ROUTE_CASES[case]
    tdt = {"f64": torch.float64, "f32": torch.float32, "bf16": torch.bfloat16}[dtype]
    calls = []
    monkeypatch.setattr(K, "use_kernel", lambda *t: True)
    monkeypatch.setattr(K, "launch", lambda *args: calls.append(args))
    T, faces, Cm = (torch.zeros(shape, dtype=tdt), tuple(
        torch.zeros(tuple(1 if a == k // 2 else n for a, n in enumerate(shape)), dtype=tdt)
        for k in range(2 * len(shape))), torch.zeros(shape, dtype=tdt))
    out = torch.empty(shape, dtype=tdt)
    boxes = overlap.region_boxes(shape, overlap.effective_b_width(shape, bw))
    K.reset_launches()
    K.fused_step_cm_faces(T, faces, Cm, SPACING[len(shape)], out=out)
    for box in boxes:
        free = overlap.ghost_free(box, shape)
        K.fused_step_cm_faces(T, (None,) * len(faces) if free else faces, Cm,
                              SPACING[len(shape)], box=box, out=out)
    assert len(boxes) == 2 * len(shape) + 1
    assert K.LAUNCHES["fused_step_cm"] == 1 + len(boxes)
    assert K.F64_ROUTE_LAUNCHES == (1 + len(boxes) if dtype == "f64" else 0)
    assert {args[4] for args in calls} == {K._DTYPE_CODE[tdt]}
    K.reset_launches()
    assert K.F64_ROUTE_LAUNCHES == 0


def _stencil_constant(name):
    from rocm_mpi_tpu_torch.ops import resident

    return resident._constant("stencil.cu", name)


def _f64_cut(shape, box):
    """The f64 route's cut of a launch over `box` (csrc/stencil.cu
    launch_fused_cm_f64): (cells a lane, lanes a segment, the strips'
    first cell, strips, rows a run)."""
    cells = _stencil_constant("kF64Cells2" if len(shape) == 2 else "kF64Cells3")
    (lo, hi), seg = box[-1], 32
    s = _stencil_constant("kF64MinSeg")
    while s < 32:
        if hi - (lo - lo % (s * cells)) <= s * cells:
            seg = s
            break
        s *= 2
    a0 = lo - lo % (seg * cells)
    strips = -(-(hi - a0) // (seg * cells))
    e_mid = box[1][1] - box[1][0] if len(shape) == 3 else 1
    run = strips * e_mid * (box[0][1] - box[0][0]) // (
        _stencil_constant("kMsFillWarps") * (32 // seg))
    return cells, seg, a0, strips, min(max(run, 1), _stencil_constant("kF64RunRows"))


def _f64_route_step(T, faces, Cm, inv_d2, box, out, outer=True):
    """The f64 route in plain PyTorch, one segment at a time: a segment of
    `seg` lanes walks a strip of seg · cells cells of the last axis (lane
    l's cells l + seg·e) down a run of rows; a cell's last-axis neighbours
    from the segment's lanes (a rotation) or, for the strip's two outer
    cells, the loads of its first and last lane (0 when not `outer`); a
    row read only at the box's cells and one neighbour a side, from T, the
    axis-0 faces above and below the core, the cell just past the core
    from the last-axis face; writes the box's cells of `out`."""
    nd = T.ndim
    cells, seg, a0, strips, run_rows = _f64_cut(T.shape, box)
    n0, n_last = T.shape[0], T.shape[-1]
    (lo0, hi0), (lo_last, hi_last) = box[0], box[-1]
    mids = range(*box[1]) if nd == 3 else [None]
    Tp = K.assemble_padded(T, faces)  # cell (i, [m,] x) at Tp[i + 1, [m + 1,] x + 1]
    cols = torch.arange(seg)[:, None] + seg * torch.arange(cells)[None, :]

    def cell(i, m, x, reads):
        """The values at row i, axis-1 index m, columns x (0 where not read:
        outside the box's reach, or a corner of the padded block)."""
        x = torch.as_tensor(x)
        ok = reads & (x >= lo_last - 1) & (x <= hi_last) & (x <= n_last)
        ok &= (0 <= i < n0) | (x < n_last)
        at = (i + 1, *(() if m is None else (m + 1,)))
        return torch.where(ok, Tp[at][x.clamp(-1, n_last) + 1], torch.zeros((), dtype=T.dtype))

    for m in mids:
        for s in range(strips):
            first = a0 + s * seg * cells
            x = first + cols
            for r0 in range(lo0, hi0, run_rows):
                for i in range(r0, min(r0 + run_rows, hi0)):
                    c = cell(i, m, x, True)
                    rot_l, rot_r = torch.roll(c, 1, dims=0), torch.roll(c, -1, dims=0)
                    lo, hi = rot_l.clone(), rot_r.clone()
                    lo[0, 1:], hi[-1, :-1] = rot_l[0, :-1], rot_r[-1, 1:]
                    lo[0, 0] = cell(i, m, first - 1, outer)
                    hi[-1, -1] = cell(i, m, first + seg * cells, outer)
                    lap = ((cell(i + 1, m, x, True) - 2.0 * c) + cell(i - 1, m, x, True)) * inv_d2[0]
                    if nd == 3:
                        mh = cell(i, m + 1, x, True)
                        ml = cell(i, m - 1, x, True)
                        lap = lap + ((mh - 2.0 * c) + ml) * inv_d2[1]
                    lap = lap + ((hi - 2.0 * c) + lo) * inv_d2[-1]
                    at = (i, *(() if m is None else (m,)))
                    keep = (x >= lo_last) & (x < hi_last)
                    out[at][x[keep]] = (c + Cm[at][x.clamp(max=n_last - 1)] * lap)[keep]
    return out


# (shard, hide b_width, face set): the hide cell's cut at a small size
# (4-column slabs: segments of 4 lanes), a ragged last axis (the cell past
# the core inside a strip), 3D boxes 2 cells wide, and narrow boxes
# beside a domain edge.
F64_CUT_CASES = [((80, 72), (32, 4), "all"), ((37, 29), (8, 4), "all"),
                 ((37, 29), (8, 4), "low-edges"), ((21, 45), (4, 5), "none"),
                 ((12, 10, 20), (2, 2, 2), "all"), ((9, 7, 3), (2, 2, 1), "low-edges")]


@pytest.mark.parametrize("case", range(len(F64_CUT_CASES)))
def test_f64_route_cut_equals_the_plain_step_bitwise(case):
    # The f64 route's cut adapts to each box's shape (segments as narrow
    # as the box, strips on their own grid) and still reads every cell its
    # box needs, whole and box by box.
    shape, bw, faces_set = F64_CUT_CASES[case]
    T, faces, Cm = _inputs(shape, np.float64, faces_set, seed=3)
    T, Cm = torch.from_numpy(T), torch.from_numpy(Cm)
    faces = tuple(None if f is None else torch.from_numpy(f) for f in faces)
    inv_d2 = K.inv_d2_of(SPACING[len(shape)])
    boxes = overlap.region_boxes(shape, overlap.effective_b_width(shape, bw))
    segs = {_f64_cut(shape, b)[1] for b in boxes}
    assert min(segs) < 32  # a narrow box packs several runs into a warp
    for group in ([K.core_box(shape)], boxes):
        got = torch.full(shape, float("nan"), dtype=torch.float64)
        want = torch.full(shape, float("nan"), dtype=torch.float64)
        for b in group:
            _f64_route_step(T, faces, Cm, inv_d2, b, got)
            K.fused_step_cm_faces_plain(T, faces, Cm, inv_d2, box=b, out=want)
        assert torch.equal(got, want)


def test_the_f64_route_needs_the_outer_loads():
    # Without its first and last lanes' loads of the strip's outer
    # neighbours a segment does not give the step.
    T, faces, Cm = _inputs((80, 72), np.float64, "all", seed=4)
    T, Cm = torch.from_numpy(T), torch.from_numpy(Cm)
    faces = tuple(torch.from_numpy(f) for f in faces)
    inv_d2 = K.inv_d2_of(SPACING[2])
    box = ((32, 48), (0, 4))
    got = _f64_route_step(T, faces, Cm, inv_d2, box, torch.zeros(80, 72, dtype=torch.float64),
                          outer=False)
    want = K.fused_step_cm_faces_plain(T, faces, Cm, inv_d2, box=box,
                                       out=torch.zeros(80, 72, dtype=torch.float64))
    assert not torch.equal(got, want)


# ---------------------------------------------------------------------------
# 4 gloo ranks: the face exchange, and the sharded perf and hide runs
# ---------------------------------------------------------------------------

# (global shape, dims, wire mode, state dtype)
EXCHANGES = {
    "2d-f64": ((40, 36), (2, 2), "f32", "f64"),
    "2d-f32": ((40, 36), (2, 2), "f32", "f32"),
    "2d-f32-bf16wire": ((40, 36), (2, 2), "bf16", "f32"),
    "2d-bf16": ((40, 36), (2, 2), "f32", "bf16"),
    "3d-f64": ((12, 10, 8), (2, 2, 1), "f32", "f64"),
    "3d-f32-bf16wire": ((12, 10, 8), (2, 2, 1), "bf16", "f32"),
}
CALLS = 3
# (global shape, dims, dtype, wire, variant, driver, b_width); the 2D shards
# are 20×18, the 3D 6×5×8.
RUNS = {}
for _dt in ("f64", "f32"):
    for _var in ("perf", "hide"):
        for _drv in ("step", "scan"):
            RUNS[f"2d-{_dt}-{_var}-{_drv}"] = ((40, 36), (2, 2), _dt, "f32", _var, _drv, (4, 3))
            RUNS[f"3d-{_dt}-{_var}-{_drv}"] = ((12, 10, 8), (2, 2, 1), _dt, "f32", _var, _drv,
                                               (2, 2, 2))
RUNS["2d-f64-hide-noint-step"] = ((40, 36), (2, 2), "f64", "f32", "hide", "step", (32, 4))
RUNS["2d-bf16-perf-step"] = ((40, 36), (2, 2), "bf16", "f32", "perf", "step", (4, 3))
RUNS["2d-bf16-hide-scan"] = ((40, 36), (2, 2), "bf16", "f32", "hide", "scan", (4, 3))
RUNS["2d-f32-perf-bf16wire"] = ((40, 36), (2, 2), "f32", "bf16", "perf", "step", (4, 3))
RUNS["3d-f32-hide-bf16wire"] = ((12, 10, 8), (2, 2, 1), "f32", "bf16", "hide", "scan",
                                (2, 2, 2))
NT = 12
# The runs held against the JAX package (f64, f32 and the full-precision
# wire; from JAX's own initial state).
JAX_RUNS = sorted(k for k, v in RUNS.items() if v[2] in TOL and v[3] == "f32")


def _jax_model(key):
    shape, dims, dtype, wire, _, _, bw = RUNS[key]
    cfg = JaxConfig(global_shape=shape, lengths=(10.0,) * len(shape), nt=NT, warmup=0,
                    dtype=dtype, dims=dims, b_width=bw, wire_mode=wire)
    return JaxHeatDiffusion(cfg, devices=jax.devices()[:NPROCS])


@pytest.fixture(scope="module")
def ranks():
    states = {k: tuple(np.asarray(a) for a in _jax_model(k).init_state()) for k in JAX_RUNS}
    spec = dict(exchanges=EXCHANGES, calls=CALLS, runs=RUNS, states=states, nt=NT, warmup=0)
    return spawn_ranks(NPROCS, worker.run_faces_rank, (spec,), backend="gloo", timeout=300)


@pytest.mark.parametrize("key", sorted(EXCHANGES))
def test_exchange_faces_equal_the_padded_ghosts(ranks, key):
    for r in ranks:
        case = r["exchange"][key]
        for face in case["faces"]:
            # A face exactly where a neighbour is, equal to the padded
            # exchange's ghost bit for bit (bf16 wire: decoded alike); the
            # ghost of a missing neighbour is zero, as the None face reads.
            assert face["none"] is not face["neighbour"]
            assert face["same"]


@pytest.mark.parametrize("key", sorted(EXCHANGES))
def test_exchange_faces_is_one_batch_on_kept_buffers(ranks, key):
    for r in ranks:
        case = r["exchange"][key]
        # One batch_isend_irecv a call for every axis: a send and a receive
        # for each neighbour (2 on every rank of a 2×2 grid).
        assert case["batches_per_call"] == [1] * CALLS
        assert case["sizes"] == [4] * CALLS
        # The same face buffers at every call (what a captured step needs).
        assert all(p == case["pointers"][0] for p in case["pointers"])


@pytest.mark.parametrize("key", sorted(RUNS))
def test_sharded_face_route_is_the_padded_route_bitwise(ranks, key):
    assert all(r["runs"][key]["same"] for r in ranks)


@pytest.mark.parametrize("key", JAX_RUNS)
def test_sharded_face_runs_match_jax_4_device(ranks, key):
    dtype = RUNS[key][2]
    variant = RUNS[key][4]
    got = ranks[0]["runs"][key]["field"]
    assert all(r["runs"][key]["field"] is None for r in ranks[1:])
    ref = np.asarray(_jax_model(key).run(variant).T)
    assert got.shape == RUNS[key][0]
    np.testing.assert_allclose(got, ref, **TOL[dtype])


def test_sharded_face_runs_launch_no_kernel_on_cpu(ranks):
    for r in ranks:
        assert set(r["launches"].values()) == {0}
