"""The SA-block variants of ``scripts/exp_kernels.py`` in the port
(``mixermdm_tpu_torch/ops/sa_variants.py``), and the W8A8 blocks' route
around a fused plan that refuses a shape, on the CPU.

The oracle is each JAX function of ``scripts/exp_kernels.py``, loaded from
its file (not edited) and run with its Pallas kernel in TPU interpret mode
(``pltpu.force_tpu_interpret_mode()``); the port's side is its plain
version, which the CPU runs (``chip_smoke.py`` holds the CUDA kernels
``sa_block`` and ``sa_block_i8x`` to the same plain versions on the card).
Inputs come from a numpy seed at B 2, E 128, H 2 (head dim 64), in f32, and
go to both as numpy arrays; weights reach the port through
``sa_weights_from_jax``.  Every configuration runs at one of T = 8 (no
padding) and T = 7 (keys and queries padded to 8): each family and each of
quant off / on sees both, and ``skip_softmax`` runs at T = 7, where the
padded key's -1e30 logit reaches the output.  (One interpreted Pallas call
costs about half a second to trace and compile here; every configuration at
both lengths would take the file past its time budget.  The interpreted
programs are compiled at XLA's lowest backend optimisation level, which
cuts that compile time by a third.)

Tolerances:
* f32 paths: max |port - JAX| <= ``F32_TOL`` of max |JAX| (readings 1e-7 to
  4e-7: the same f32 arithmetic, sums in another order);
* int8 paths (``quant``, ``sa_int8x``): on top of that, a value may differ
  by one int8 step of the out-projection dequantised, max |JAX - x| / 127,
  where a value on a rounding boundary moves (readings: every int8 value
  equal, differences 1e-7 to 3e-7 of max);
* ``skip_softmax`` at T = 7: the same limits relative to the largest
  finite value (the padded key puts 1e30-sized values in every row), and
  the non-finite values, if any, equal in place and value.
"""

import functools
import importlib
import importlib.util
import os

import jax
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from mixermdm_tpu_torch.ops import _lib
from mixermdm_tpu_torch.ops import attention as tattn
from mixermdm_tpu_torch.ops import fused_block as tblock
from mixermdm_tpu_torch.ops import sa_variants as sv
from mixermdm_tpu_torch.scripts import exp_kernels as tek

tlq = importlib.import_module("mixermdm_tpu_torch.ops.linear_q8")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(REPO, "mixermdm_tpu_torch", "csrc")
_spec = importlib.util.spec_from_file_location("jax_exp_kernels",
                                               os.path.join(REPO, "scripts", "exp_kernels.py"))
jexp = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(jexp)

B, E, H = 2, 128, 2
F32_TOL = 1e-5
FAST_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def data():
    """Per T: numpy inputs, the JAX arrays, the port's tensors and weights."""
    out = {}
    for T in (7, 8):
        rng = np.random.default_rng(T)
        x = (rng.standard_normal((B, T, E)) * 0.5).astype(np.float32)
        sc = (rng.standard_normal((B, E)) * 0.2).astype(np.float32)
        sh = (rng.standard_normal((B, E)) * 0.2).astype(np.float32)
        ws = [(rng.standard_normal((E, E)) * E ** -0.5).astype(np.float32) for _ in range(4)]
        bs = [(rng.standard_normal(E) * 0.1).astype(np.float32) for _ in range(4)]
        kpm = np.zeros((B, T), bool)
        kpm[1, -2:] = True  # two masked keys in the second sequence
        wb = sum(zip(ws, bs), ())
        import jax.numpy as jnp

        out[T] = dict(
            x=x, j=[jnp.asarray(a) for a in (x, sc, sh)], jwb=[jnp.asarray(a) for a in wb],
            jkpm=jnp.asarray(kpm), t=[torch.from_numpy(a) for a in (x, sc, sh)],
            tkpm=torch.from_numpy(kpm), w=sv.sa_weights_from_jax(*wb, quant=True),
            wb=wb)
    return out


def _static_as(d):
    """The JAX script's self-calibrated activation scale (exp_kernels.py:832-835)."""
    xn = jexp._ln(d["j"][0], 1e-6) * (1.0 + d["j"][1][:, None]) + d["j"][2][:, None]
    return float(np.abs(np.asarray(xn)).max()) / 127.0


def _jax(fn, *args, **kw):
    with pltpu.force_tpu_interpret_mode():
        run = jax.jit(functools.partial(fn, **kw)).lower(*args).compile(FAST_COMPILE)
        return np.asarray(run(*args), np.float32)


def _assert_close(got, want, x, *, int8: bool):
    got = got.float().numpy()
    fin = np.isfinite(want)
    assert np.array_equal(fin, np.isfinite(got))
    assert np.array_equal(got[~fin], want[~fin])
    scale = np.abs(want[fin]).max()
    tol = F32_TOL * scale
    if int8:
        tol += np.abs(want - x[:, :want.shape[1]])[fin].max() / 127.0
    assert np.abs(got[fin] - want[fin]).max() <= tol, (np.abs(got[fin] - want[fin]).max(), tol)


# T per configuration: each family and quant value sees T = 7 and T = 8.
VARIANT_CASES = [(rows, recip, quant, 7 if (rows - 1 + recip + quant) % 2 == 0 else 8)
                 for rows in (1, 2) for recip in (False, True) for quant in (False, True)]
ABLATE_CASES = [("full", {}, False, 8), ("full", {}, True, 7),
                ("no-softmax", dict(skip_softmax=True), False, 7),
                ("no-softmax", dict(skip_softmax=True), True, 7),
                ("no-attn", dict(skip_attn=True), False, 7),
                ("no-attn", dict(skip_attn=True), True, 8),
                ("no-ln", dict(skip_ln=True), False, 8), ("no-ln", dict(skip_ln=True), True, 7),
                ("no-attn,no-ln", dict(skip_attn=True, skip_ln=True), False, 7),
                ("no-attn,no-ln", dict(skip_attn=True, skip_ln=True), True, 8)]
LEVER_CASES = [("static", 7), ("qpv", 8), ("qpv+qqk", 7), ("static+qpv+qqk", 8)]


@pytest.mark.parametrize("rows,recip,quant,T", VARIANT_CASES,
                         ids=[f"rows{r}-recip{int(c)}-q{int(q)}-T{t}" for r, c, q, t in VARIANT_CASES])
def test_sa_variant_matches_jax(data, rows, recip, quant, T):
    d = data[T]
    want = _jax(jexp.sa_variant, *d["j"], *d["jwb"], d["jkpm"], n_heads=H, rows=rows,
                recip=recip, quant=quant)
    got = sv.sa_variant(*d["t"], d["w"], d["tkpm"], n_heads=H, rows=rows, recip=recip,
                        quant=quant)
    _assert_close(got, want, d["x"], int8=quant)


@pytest.mark.parametrize("quant,T", [(False, 8), (True, 7)], ids=["q0-T8", "q1-T7"])
def test_sa_headbatch_matches_jax(data, quant, T):
    d = data[T]
    want = _jax(jexp.sa_headbatch, *d["j"], *d["jwb"], n_heads=H, quant=quant)
    got = sv.sa_headbatch(*d["t"], d["w"], n_heads=H, quant=quant)
    _assert_close(got, want, d["x"], int8=quant)


@pytest.mark.parametrize("name,skips,quant,T", ABLATE_CASES,
                         ids=[f"{n}-q{int(q)}-T{t}" for n, _, q, t in ABLATE_CASES])
def test_sa_ablate_matches_jax(data, name, skips, quant, T):
    d = data[T]
    want = _jax(jexp.sa_ablate, *d["j"], *d["jwb"], n_heads=H, quant=quant, **skips)
    got = sv.sa_ablate(*d["t"], d["w"], n_heads=H, quant=quant, **skips)
    _assert_close(got, want, d["x"], int8=quant)


@pytest.mark.parametrize("levers,T", LEVER_CASES, ids=[f"{lv}-T{t}" for lv, t in LEVER_CASES])
def test_sa_int8x_matches_jax(data, levers, T):
    d = data[T]
    kw = tek.lever_kwargs(levers, _static_as(d))
    want = _jax(jexp.sa_int8x, *d["j"], *d["jwb"], d["jkpm"], n_heads=H, **kw)
    got = sv.sa_int8x(*d["t"], d["w"], d["tkpm"], n_heads=H, **kw)
    _assert_close(got, want, d["x"], int8=True)


def test_int8_weights_are_the_jax_ones(data):
    """The merged int8 weights and scales are bitwise JAX's quantize_weight of
    the script's concatenated (E, 3E) matrix and of wo."""
    d = data[8]
    wq, _, wk, _, wv, _, wo, _ = d["wb"]
    j8, js = jexp.quantize_weight(np.concatenate([wq, wk, wv], axis=1))
    assert np.array_equal(d["w"].w8_qkv.numpy(), np.asarray(j8).T)
    assert np.array_equal(d["w"].s_qkv.numpy(), np.asarray(js)[0])
    j8, js = jexp.quantize_weight(wo)
    assert np.array_equal(d["w"].w8_o.numpy(), np.asarray(j8).T)
    assert np.array_equal(d["w"].s_o.numpy(), np.asarray(js)[0])


def test_static_scale_is_the_jax_calibration(data):
    d = data[7]
    inp = tek.Inputs(*d["t"], list(d["wb"][0::2]), list(d["wb"][1::2]), d["tkpm"], H)
    assert tek.static_scale(inp) == pytest.approx(_static_as(d), rel=1e-6)
    inv, sa = sv.static_scales(0.1)
    assert inv == float(np.float32(10.0)) and sa == float(np.float32(0.1))


def test_bound_counts_the_work_the_block_needs():
    """The bound counts the T rows and the unmasked keys, not the padded
    length the cost estimate (TFLOP/s) counts; skipping the attention drops
    its products, and int8 products go at the int8 peak."""
    B, T, E = 40, 299, 1024
    proj, attn = 8 * B * T * E * E, 4 * B * T * T * E
    ms, by = tek.bound(B, T, E, quant=False)
    assert by == "operations" and ms == pytest.approx(1e3 * (proj + attn) / tek.H100_BF16_FLOPS)
    assert tek.bound(B, T, E, quant=False, skip_attn=True)[0] == pytest.approx(
        1e3 * proj / tek.H100_BF16_FLOPS)
    assert tek.bound(B, T, E, quant=False, keys=B * T // 2)[0] == pytest.approx(
        1e3 * (proj + attn / 2) / tek.H100_BF16_FLOPS)
    assert tek.bound(B, T, E, quant=True, qqk=True, qpv=True)[0] == pytest.approx(
        1e3 * (proj + attn) / tek.H100_INT8_OPS)
    Tp = sv.padded_len(T)
    assert Tp == 304 and tek.cost_flops(B, T, E) == 2 * B * Tp * E * (4 * E + 2 * Tp)


@pytest.mark.parametrize("fault", ["none", "no zero key", "p 1e-4 high"])
def test_qpv_witness_flags_a_systematic_error_in_p(fault):
    """chip_smoke's witness of the int8 p.v limit: on the same q, k, v, an
    attention whose p8 differ from the plain ones only at keys next to a
    rounding boundary passes; a denominator without the zero key, or p one
    part in 1e4 too large, leaves sums that no boundary key explains."""
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    Bw, T, Ew, Hw = 1, 299, 256, 2
    inp = tek.make_inputs(Bw, T, Ew, Hw, device="cpu", dtype=torch.bfloat16)
    w = tek.weights(inp)
    qkv = sv.sa_int8x_qkv_plain(inp.x, inp.scale, inp.shift, w)
    _, kpm = sv._pad(inp.x, None)
    q, k, v = qkv.split(Ew, dim=-1)
    p = sv.int8_attention_probs(q, k, kpm, n_heads=Hw, qqk=False,
                                zero_attn=fault != "no zero key")
    v8, vs = sv.quant_v(v, Hw)
    p8 = torch.round(p * 127.0 * (1 + 1e-4 if fault == "p 1e-4 high" else 1.0))
    attn = sv._merge(sv._int_matmul(p8, v8) * (vs / 127.0)[:, None, None, None])
    # without int8 q.k^T the kernel's q and k are its bf16 operands
    mid = {"q": q.to(torch.bfloat16), "k": k.to(torch.bfloat16), "v": v, "attn": attn}
    wit = cs._qpv_witness(sv, mid, kpm, Hw, T, False)
    assert wit["values"] == Bw * T * Ew
    if fault == "none":
        assert wit["differ"] == wit["unexplained"] == 0
    else:
        assert wit["unexplained"] > 0.01 * wit["values"]


@pytest.mark.parametrize("quant", [False, True], ids=["q0", "q1"])
def test_output_does_not_depend_on_rows(data, quant):
    d = data[8]
    outs = [sv.sa_variant(*d["t"], d["w"], d["tkpm"], n_heads=H, rows=r, quant=quant)
            for r in (1, 2)]
    assert torch.equal(outs[0], outs[1])
    with pytest.raises(ValueError, match="multiple of rows"):
        sv.sa_variant(*d["t"], d["w"], d["tkpm"], n_heads=H, rows=3)


def test_plan_is_one_resident_grid_and_refuses_what_does_not_fit():
    """One block of THREADS (a producer and two consumer warpgroups) per SM,
    or as many as the occupancy query allows, whatever B and T: every block
    reaches each grid-wide barrier; the shared memory of a block fits the
    227 KB an H100 block may have at both head dims, and no two fit an SM;
    a card that holds none raises before any launch."""
    assert sv.THREADS == 384
    for D in sv.HEAD_DIMS:
        assert sv.sa_smem_bytes(D) <= sv.SMEM_LIMIT < 2 * sv.sa_smem_bytes(D)
    for i8x in (False, True):
        asked = []
        occupancy = lambda D, i, n: asked.append((D, i)) or n  # noqa: E731
        assert sv.sa_block_plan(1024, 8, i8x=i8x, sms=132,
                                occupancy=lambda D, i: occupancy(D, i, 1)) == 132
        assert sv.sa_block_plan(512, 8, i8x=i8x, sms=132,
                                occupancy=lambda D, i: occupancy(D, i, 2)) == 264
        assert asked == [(128, i8x), (64, i8x)]
        with pytest.raises(RuntimeError, match="no block"):
            sv.sa_block_plan(1024, 8, i8x=i8x, occupancy=lambda D, i: 0)


def _constexprs(path):
    import re

    with open(path) as f:
        src = f.read()
    return {m.group(1): int(m.group(2))
            for m in re.finditer(r"constexpr int (\w+) = (\d+);", src)}, src


def test_constants_match_the_kernels():
    """The flags, the block (THREADS), the products' tile and ring, the
    attention tiles and stages and the shared memory formula of
    csrc/sa_common.cuh are the host plan's; both head dims are
    instantiated in both kernels."""
    c, src = _constexprs(os.path.join(CSRC, "sa_common.cuh"))
    flags = {"kQuant": sv.F_QUANT, "kRecip": sv.F_RECIP, "kHeadBatch": sv.F_HEADBATCH,
             "kSkipLn": sv.F_SKIP_LN, "kSkipAttn": sv.F_SKIP_ATTN,
             "kSkipSoftmax": sv.F_SKIP_SOFTMAX, "kRoundAttn": sv.F_ROUND_ATTN,
             "kResidual": sv.F_RESIDUAL, "kZeroAttn": sv.F_ZERO_ATTN, "kStatic": sv.F_STATIC,
             "kQpv": sv.F_QPV, "kQqk": sv.F_QQK}
    assert {k: c[k] for k in flags} == flags
    assert c["kThreads"] == sv.THREADS
    assert c["kBM"] == c["kBN"] == sv.GEMM_TILE and c["kSlab"] == 128
    assert c["kGemmStages"] == sv.GEMM_STAGES and c["kEpiStride"] == sv.EPI_STRIDE
    assert c["kRows"] == sv.ATTN_ROWS and c["kKeys"] == sv.ATTN_KEYS
    assert c["kMaxAttnStages"] == max(sv.ATTN_STAGES.values())
    assert "return D == 64 ? %d : %d;" % (sv.ATTN_STAGES[64], sv.ATTN_STAGES[128]) in src
    assert "kAttnWarpgroups = kThreads / 128;" in src and sv.THREADS // 128 == sv.ATTN_WARPGROUPS
    for formula in ("kGemmStage = (kBM + kBN) * kSlab;",
                    "kEpiWgBytes = 64 * kEpiStride + 2 * kBN * 4;",
                    "kGemmBytes = kGemmStages * kGemmStage + 2 * kEpiWgBytes;",
                    "return kRows * 2 * D;", "return 2 * kKeys * 2 * D;",
                    "return q_tile_bytes(D) + attn_stages(D) * kv_stage_bytes(D);",
                    "kStgBytes = kRows * kEpiStride;",
                    "return kAttnWarpgroups * (attn_wg_bytes(D) + kStgBytes);",
                    "return kGemmBytes > attn_bytes(D) ? kGemmBytes : attn_bytes(D);",
                    "kWgBarriers = 1 + kMaxAttnStages;",
                    "kBarriers = 2 * kGemmStages + kAttnWarpgroups * kWgBarriers;",
                    "return sm90::kSmemAlign + ring_bytes(D) + 8 * kBarriers;"):
        assert formula in src, formula
    # sa_block one instantiation per head dim; sa_block_i8x two, without
    # and with the int8 attention operands, each queried for occupancy,
    # given its shared memory at load and launched
    for name, insts in (("sa_block.cu", ("",)), ("sa_block_i8x.cu", (", false", ", true"))):
        with open(os.path.join(CSRC, name)) as f:
            kernel = f.read()
        kern = "sa_block_i8x_kernel" if "i8x" in name else "sa_block_kernel"
        for inst in insts:
            assert f"{kern}<D{inst}>, kThreads, sa_smem_bytes(D));" in kernel
            for D in sv.HEAD_DIMS:
                assert f"cudaFuncSetAttribute({kern}<{D}{inst}>, attr, sa_smem_bytes({D}));" \
                    in kernel
                assert f"launch({kern}<{D}{inst}>, m, p, grid, sa_smem_bytes({D}), s)" in kernel
    assert {"sa_block.cu", "sa_block_i8x.cu"} <= set(_lib.SOURCES)
    assert "sa_common.cuh" in _lib.HEADERS
    assert {"mm_sa_block_init", "mm_sa_block_i8x_init"} <= set(_lib.INIT_FUNCTIONS)


# The shapes whose tile walks the kernels take: the SA blocks' (B 8), the
# experiment script's (B 40), the mixer's width (D 64) and the tests' own.
WALK_SHAPES = [(8, 299, 1024, 8), (40, 299, 1024, 8), (8, 299, 512, 8), (2, 7, 128, 2),
               (2, 8, 128, 2)]


def _c_block(src, pattern, what):
    import re

    m = re.search(pattern, src, re.M | re.S)
    assert m, f"{what} not found"
    return m.group(0)


@pytest.fixture(scope="module")
def c_walks(tmp_path_factory):
    """The kernels' own work walks, compiled for the host: ``Tiles`` and
    ``Walk`` of csrc/sa_common.cuh, the products' tile loop and tile origin
    as gemm_produce has them (gemm_consume's the same, its warpgroup's 64
    rows in), and ``key_position`` of csrc/sa_block_i8x.cu, cut from the
    sources as they stand and built with the host ``c++`` behind a stub of
    ``gridDim`` / ``blockIdx`` and ``Params``."""
    import ctypes
    import shutil
    import subprocess

    c, src = _constexprs(os.path.join(CSRC, "sa_common.cuh"))
    with open(os.path.join(CSRC, "sa_block_i8x.cu")) as f:
        i8x = f.read()
    tiles = _c_block(src, r"^struct Tiles \{\n.*?^\};\n", "Tiles")
    walk = _c_block(src, r"^struct Walk \{\n.*?^\};\n", "Walk")
    keypos = _c_block(i8x, r"^__device__ __forceinline__ int key_position\(int r\) \{\n.*?^\}\n",
                      "key_position")
    produce = _c_block(src, r"^__device__ __forceinline__ void gemm_produce\(.*?^\}\n", "produce")
    consume = _c_block(src, r"^__device__ __forceinline__ void gemm_consume\(.*?^\}\n", "consume")
    loop = "for (int tile = blockIdx.x; tile < tl.tiles; tile += gridDim.x) {"
    origin = _c_block(produce, r"const int m0 = .*?;$", "the tile origin")
    assert produce.count(loop) == consume.count(loop) == 1
    assert origin.replace(" * kBM,", " * kBM + cw * 64,") in consume
    consts = "".join(f"constexpr int {k} = {c[k]};\n"
                     for k in ("kThreads", "kRows", "kHeadBatch", "kBM", "kBN", "kSlab"))
    harness = f"""
#define __device__
#define __forceinline__ inline
struct Dim {{ int x; }};
static Dim gridDim, blockIdx;
struct Params {{ int B, Tp, H, rows, flags; }};
{consts}constexpr int kAttnWarpgroups = kThreads / 128;
{tiles}{walk}{keypos}
extern "C" int c_key_position(int r) {{ return key_position(r); }}
extern "C" int c_gemm_tiles(int M, int N, int grid, int blk, int* out) {{
  gridDim.x = grid;
  blockIdx.x = blk;
  const Tiles tl(M, N, kSlab);
  int n = 0;
  {loop}
    {origin}
    out[2 * n] = m0;
    out[2 * n + 1] = n0;
    ++n;
  }}
  return n;
}}
extern "C" int c_walk(int B, int Tp, int H, int rows, int flags, int grid, int gw, int* out) {{
  gridDim.x = grid;
  Params p;
  p.B = B, p.Tp = Tp, p.H = H, p.rows = rows, p.flags = flags;
  const Walk w(p, gw);
  const int n = w.count();
  for (int i = 0; i < n; ++i) w.tile(i, out[3 * i], out[3 * i + 1], out[3 * i + 2]);
  return n;
}}
"""
    d = tmp_path_factory.mktemp("sa_walks")
    (d / "walks.cpp").write_text(harness)
    subprocess.run([shutil.which("c++") or "c++", "-std=c++17", "-shared", "-fPIC", "-o",
                    str(d / "walks.so"), str(d / "walks.cpp")], check=True)
    return ctypes.CDLL(str(d / "walks.so"))


def _gemm_walk(lib, M, N, grid):
    """Per block the (m0, n0) of the 128 x 128 tiles it takes, in order."""
    import ctypes

    buf = (ctypes.c_int * (2 * (-(-M // 128) * (N // 128))))()
    out = []
    for blk in range(grid):
        n = lib.c_gemm_tiles(M, N, grid, blk, buf)
        out.append([(buf[2 * i], buf[2 * i + 1]) for i in range(n)])
    return out


def _attention_walk(lib, B, Tp, H, grid, rows, head_batch):
    """Per grid warpgroup (w * grid + block) the (b, h, q0) it takes."""
    import ctypes

    buf = (ctypes.c_int * (3 * B * H * -(-Tp // 64)))()
    flags = sv.F_HEADBATCH if head_batch else 0
    out = []
    for gw in range(sv.ATTN_WARPGROUPS * grid):
        n = lib.c_walk(B, Tp, H, rows, flags, grid, gw, buf)
        out.append([tuple(buf[3 * i:3 * i + 3]) for i in range(n)])
    return out


@pytest.mark.parametrize("B,T,E,H", WALK_SHAPES, ids=[f"{b}x{t}x{e}" for b, t, e, _ in WALK_SHAPES])
@pytest.mark.parametrize("grid", [132, 7])
def test_product_walks_cover_every_tile_once(c_walks, B, T, E, H, grid):
    """The QKV product's and the out-projection's 128 x 128 tiles, as the
    kernels' tile loop hands them out: each block's list, all of them
    together, every tile of (B Tp, N) once."""
    M = B * sv.padded_len(T)
    for N in (3 * E, E):
        walk = _gemm_walk(c_walks, M, N, grid)
        tiles = [t for blk in walk for t in blk]
        want = {(m, n) for m in range(0, M, 128) for n in range(0, N, 128)}
        assert len(tiles) == len(want) and set(tiles) == want
        assert max(map(len, walk)) - min(map(len, walk)) <= 1  # one wave apart at most


@pytest.mark.parametrize("B,T,E,H", WALK_SHAPES, ids=[f"{b}x{t}x{e}" for b, t, e, _ in WALK_SHAPES])
@pytest.mark.parametrize("grid", [132, 7])
def test_attention_walks_cover_every_tile_once(c_walks, B, T, E, H, grid):
    """The kernels' ``Walk``: every (sequence, head, 64-row query tile) once
    over the 3 grid warpgroups, for rows 1 and 2 and the head-batched walk;
    a unit's tiles follow each other in one warpgroup."""
    Tp = sv.padded_len(T)
    want = {(b, h, q) for b in range(B) for h in range(H) for q in range(0, Tp, 64)}
    for rows, hb in ((1, False), (2, False), (1, True)):
        walk = _attention_walk(c_walks, B, Tp, H, grid, rows, hb)
        tiles = [t for wg in walk for t in wg]
        assert len(tiles) == len(want) and set(tiles) == want
        per_unit = rows * (H if hb else 1)
        for wg in walk:
            assert len(wg) % per_unit == 0
            for u in range(0, len(wg), per_unit):
                unit = wg[u:u + per_unit]
                assert len({q for _, _, q in unit}) == 1
                assert len({b // rows for b, _, _ in unit}) == 1


def test_phase_stamps_read_as_phases():
    """The phases of each form, one per grid barrier (and the last), and
    the stamps of a reading turned into ns per phase."""
    assert sv.phase_names(sv.F_RESIDUAL, False) == ("ln", "qkv", "attention", "out")
    assert sv.phase_names(sv.F_QUANT, False) == ("ln", "qkv", "attention", "quant_attn", "out")
    assert sv.phase_names(sv.F_QUANT | sv.F_STATIC, True) == (
        "ln", "qkv", "attention", "quant_attn", "out")
    assert sv.phase_names(sv.F_QUANT | sv.F_QPV, True) == (
        "ln", "qkv", "operands", "attention", "quant_attn", "out")
    names = sv.phase_names(sv.F_QUANT, False)
    buf = torch.tensor([100, 110, 130, 160, 170, 0, 0, 200])
    assert sv.phase_ns((names, buf)) == {"ln": 10, "qkv": 20, "attention": 30,
                                         "quant_attn": 10, "out": 30}


def test_int8_pv_fragment_order_gives_the_integer_sums(c_walks):
    """int8 p.v on s8 wgmma: a thread's p8 values (its logits' fragment,
    s[4 c + e] at row 16 w + g + 8 (e / 2), key 8 c + 2 t + e % 2) packed
    into A-fragment registers as csrc/sa_block_i8x.cu packs them (register
    w of k-step kk: logits c0 = 4 kk + 2 (w / 2), e0 = 2 (w % 2), bytes
    (c0, e0), (c0, e0 + 1), (c0 + 1, e0), (c0 + 1, e0 + 1)), read at the
    positions of the m16n8k32 A fragment, times v8 stored at KEY_POSITION,
    equal p8 . v8 in key order, exactly.  KEY_POSITION is the kernel's
    ``key_position``, compiled from its source."""
    assert tuple(c_walks.c_key_position(r) for r in range(32)) == sv.KEY_POSITION
    rng = np.random.default_rng(0)
    P = rng.integers(0, 128, (64, 64))
    V = rng.integers(-127, 128, (64, 32))
    A = np.zeros((64, 64), np.int64)
    for w in range(4):
        for lane in range(32):
            g, t = lane >> 2, lane & 3
            s = {4 * c + e: P[16 * w + g + 8 * (e >> 1), 8 * c + 2 * t + (e & 1)]
                 for c in range(8) for e in range(4)}
            for kk in range(2):
                for reg in range(4):
                    c0, e0 = 4 * kk + 2 * (reg >> 1), 2 * (reg & 1)
                    for byte in range(4):
                        # a0 row g, a1 row g + 8; a0 / a1 bytes 4 t.., a2 / a3 16 + 4 t..
                        row = 16 * w + g + 8 * (reg & 1)
                        A[row, 32 * kk + 16 * (reg >> 1) + 4 * t + byte] = \
                            s[4 * (c0 + (byte >> 1)) + e0 + (byte & 1)]
    Vt = np.zeros((64, 32), np.int64)
    for key in range(64):
        Vt[(key // 32) * 32 + sv.KEY_POSITION[key % 32]] = V[key]
    assert np.array_equal(A @ Vt, P @ V)


def _q8_properties(t8, t):
    """An int8 form of t (B, ..., ) with one scale per sequence: within
    [-127, 127], the sequence's largest |t| at +-127, and every value within
    half a step of t / step, the step being max |t| / 127."""
    tf, t8 = t.double(), t8.double()
    step = tf.abs().flatten(1).amax(1).clamp_min(1e-8) / 127
    assert t8.abs().max() <= 127
    assert torch.equal(t8.abs().flatten(1).amax(1), torch.full_like(step, 127.0))
    shape = (-1,) + (1,) * (t.dim() - 1)
    assert ((t8 - tf / step.view(shape)).abs() <= 0.5 + 1e-6).all()


LEVER_SETS = [(False, False), (True, False), (False, True), (True, True)]


@pytest.mark.parametrize("qqk,qpv", LEVER_SETS, ids=["bf16", "qqk", "qpv", "qqk+qpv"])
def test_i8x_operands_are_the_plain_arithmetic(c_walks, qqk, qpv):
    """sa_block_i8x's operand pass (its plain version, which the card's
    run holds the kernel's operands to bit for bit): q and k with int8
    q.k^T an int8 form with one scale per sequence, bit for bit the plain
    attention's per-sequence quantisation (else cast to bf16); v
    with int8 p.v quant_v's int8 values, the ones the plain attention
    multiplies, laid out (B, H, D, Tv) with each 32-key block's keys where
    the kernel's compiled ``key_position`` puts them and zeros past Tp
    (else cast)."""
    Bq, Tp, Eq, Hq = 2, 40, 128, 2
    D = Eq // Hq
    rng = np.random.default_rng(5)
    qkv = torch.from_numpy((rng.standard_normal((Bq, Tp, 3 * Eq)) * 0.3).astype(np.float32))
    q, k, v = qkv.split(Eq, dim=-1)
    qop, kop, vop = sv.i8x_operands_plain(qkv, Hq, qqk=qqk, qpv=qpv)
    for op, t in ((qop, q), (kop, k)):
        if qqk:
            assert op.dtype == torch.int8 and op.shape == t.shape
            _q8_properties(op, t)
            # the plain attention's per-sequence quantisation (quant_v's)
            assert torch.equal(sv._heads(op.float(), Hq), sv.quant_v(t, Hq)[0])
        else:
            assert op.dtype == torch.bfloat16 and torch.equal(op, t.to(torch.bfloat16))
    if not qpv:
        assert torch.equal(vop, v.to(torch.bfloat16))
        return
    Tv = sv.v_keys(Tp)
    assert vop.shape == (Bq, Hq, D, Tv) and vop.dtype == torch.int8 and Tv == 64
    keys = torch.stack([vop[..., blk + c_walks.c_key_position(r)] for blk in range(0, Tv, 32)
                        for r in range(32)], dim=-1)
    assert not keys[..., Tp:].any()
    by_key = keys[..., :Tp].transpose(-1, -2)  # (B, H, Tp, D)
    _q8_properties(by_key, sv._heads(v, Hq))
    assert torch.equal(by_key.float(), sv.quant_v(v, Hq)[0])


@pytest.mark.parametrize("qqk,qpv", LEVER_SETS, ids=["bf16", "qqk", "qpv", "qqk+qpv"])
def test_i8x_intermediates_lie_in_their_own_scratch(qqk, qpv):
    """What ``sa_int8x(intermediates=)`` reads after a launch: each view
    lies inside the scratch allocation the kernel writes it to (q, k, v in
    the f32 projection only where an int8 form is taken from them, else in
    the bf16 operand buffers; q8 / k8 / v8 in the operand buffers), no two
    views of one launch's scratch overlap, the shapes and dtypes are the
    kernel's."""
    Bq, Tp, Eq, Hq = 3, 40, 256, 2
    flags = sv.F_QUANT | (sv.F_QQK if qqk else 0) | (sv.F_QPV if qpv else 0)
    offsets, sizes, total = sv.scratch_layout(Bq, Tp, Eq, flags, True, 2)
    ws = torch.zeros(total, dtype=torch.uint8)
    mid = sv._operands(ws, offsets, Bq, Tp, Eq, Hq, flags, torch.bfloat16)
    names = {"q", "k", "v", "attn"} | ({"q8", "k8"} if qqk else set()) | ({"v8"} if qpv else set())
    assert set(mid) == names
    f32 = {"attn"} | ({"q", "k"} if qqk else set()) | ({"v"} if qpv else set())
    buffers = {"attn": 3, "q8": 8, "k8": 9, "v8": 10}
    spans = []
    for name, t in mid.items():
        want = (torch.float32 if name in f32 else torch.int8 if name.endswith("8")
                else torch.bfloat16)
        assert t.dtype == want, name
        assert t.shape == ((Bq, Hq, Eq // Hq, sv.v_keys(Tp)) if name == "v8" else (Bq, Tp, Eq))
        if name in buffers:
            i = buffers[name]
        elif name in f32:
            i = 2
        else:  # the bf16 operands, or the packed bf16 projection in the first
            i = 8 + "qkv".index(name) if qqk or qpv else 8
        lo = t.data_ptr() - ws.data_ptr()
        hi = lo + ((t.shape[-1] - 1) * t.stride(-1) + sum((n - 1) * st for n, st in zip(
            t.shape[:-1], t.stride()[:-1])) + 1) * t.element_size()
        assert offsets[i] <= lo and hi <= offsets[i] + sizes[i], name
        spans.append((lo, hi, name))
    if qqk or qpv:
        # q, k, v of the f32 projection are its column sections; the rest apart
        solid = sorted((lo, hi) for lo, hi, n in spans if not (n in f32 and n != "attn"))
        assert all(a[1] <= b[0] for a, b in zip(solid, solid[1:]))


# ------------------------------------------------ the W8A8 blocks' route

@pytest.fixture
def meta_kernels(monkeypatch):
    """The W8A8 blocks' kernel wrappers replaced by recorders that return
    meta tensors of the kernels' output shapes (and their device check let
    meta tensors through), so a block on the meta device runs its route
    choice and records which kernels it launched."""
    calls = []
    meta = lambda shape, dt: torch.empty(shape, dtype=dt, device="meta")  # noqa: E731

    def adaln_q8(x, *a):
        calls.append("adaln_modulate_q8")
        return meta(x.shape, torch.int8), meta(x.shape[:-1], torch.float32)

    def lin_q8(x8, xs, w8, *a, activation=None, residual=None, quant_out=False):
        name = "linear_q8_gelu_q8" if quant_out else "linear_q8"
        calls.append(name)
        shape = x8.shape[:-1] + (w8.shape[0],)
        if quant_out:
            return meta(shape, torch.int8), meta(shape[:-1], torch.float32)
        return meta(shape, torch.float32 if activation == "gelu" else torch.bfloat16)

    def att_q8(q, *a, **k):
        calls.append("attention_q8")
        B_, H_, T_, D_ = q.shape
        return meta((B_, T_, H_ * D_), torch.int8), meta((B_, T_), torch.float32)

    def att_into(q, k, v, out, *a):
        calls.append(f"attention->{str(out.dtype)[6:]}")
        return out

    def quant(x):
        calls.append("quant_rows")
        return meta(x.shape, torch.int8), meta(x.shape[:-1], torch.float32)

    for name, fn in (("adaln_modulate_q8", adaln_q8), ("linear_q8", lin_q8),
                     ("attention_q8", att_q8), ("attention_into", att_into),
                     ("quant_rows", quant)):
        monkeypatch.setattr(tblock, name, fn)
    monkeypatch.setattr(_lib, "require_cuda_bf16", lambda *a: None)  # meta tensors pass
    tattn.attention_q8_plan.cache_clear()
    tlq.gelu_q8_plan.cache_clear()
    yield calls
    tattn.attention_q8_plan.cache_clear()
    tlq.gelu_q8_plan.cache_clear()


def _meta_block(kind, E_, heads, F_=2048):
    m = lambda *s, dt=torch.bfloat16: torch.empty(s, dtype=dt, device="meta")  # noqa: E731
    x = m(8, 299, E_)
    w = (m(3 * E_, E_, dt=torch.int8), m(3 * E_, dt=torch.float32), m(3 * E_),
         m(E_, E_, dt=torch.int8), m(E_, dt=torch.float32), m(E_))
    if kind == "sa":
        return tblock.fused_sa_block_q8(x, m(8, E_), m(8, E_), *w, n_heads=heads, residual=True)
    if kind == "ca":
        return tblock.fused_ca_block_q8(x, x, *(m(8, E_) for _ in range(4)), *w, n_heads=heads,
                                        residual=True)
    return tblock.fused_ffn_block_q8(x, m(8, E_), m(8, E_), m(F_, E_, dt=torch.int8),
                                     m(F_, dt=torch.float32), m(F_), m(E_, F_, dt=torch.int8),
                                     m(E_, dt=torch.float32), m(E_), residual=True)


@pytest.mark.parametrize("kind,out", [("sa", "float32"), ("ca", "bfloat16")])
def test_attention_blocks_take_the_pair_where_the_plan_refuses(meta_kernels, monkeypatch, kind,
                                                               out):
    """16 heads of 64 at E 1024: more heads than a cluster spans; and 8
    heads on a card that holds no cluster.  The block takes the attention
    kernel (f32 out for SA, bf16 for CA) and quant_rows, counted apart; the
    shipped shape keeps the fused kernel."""
    _lib.reset_launch_counts()
    monkeypatch.setattr(tattn, "attention_q8_clusters", lambda *a: 15)
    _meta_block(kind, 1024, 16)
    assert f"attention->{out}" in meta_kernels and "quant_rows" in meta_kernels
    assert "attention_q8" not in meta_kernels and _lib.launches["attention_q8_pair"] == 1
    meta_kernels.clear()
    _meta_block(kind, 1024, 8)
    assert "attention_q8" in meta_kernels and "quant_rows" not in meta_kernels
    meta_kernels.clear()
    tattn.attention_q8_plan.cache_clear()
    monkeypatch.setattr(tattn, "attention_q8_clusters", lambda *a: 0)
    _meta_block(kind, 1024, 8)
    assert f"attention->{out}" in meta_kernels and "quant_rows" in meta_kernels
    assert _lib.launches["attention_q8_pair"] == 2


def test_ffn_block_takes_the_pair_where_the_plan_refuses(meta_kernels, monkeypatch):
    """F 4096 spans 32 tiles of 128, over a cluster's 16; and F 2048 on a
    card that holds no cluster: linear_q8 with the f32 GELU, then
    quant_rows.  The shipped F 2048 keeps the quantising product."""
    _lib.reset_launch_counts()
    monkeypatch.setattr(tlq, "_device_clusters", lambda *a: 7)
    _meta_block("ffn", 1024, 8, F_=4096)
    assert meta_kernels == ["adaln_modulate_q8", "linear_q8", "quant_rows", "linear_q8"]
    meta_kernels.clear()
    _meta_block("ffn", 1024, 8, F_=2048)
    assert meta_kernels == ["adaln_modulate_q8", "linear_q8_gelu_q8", "linear_q8"]
    meta_kernels.clear()
    tlq.gelu_q8_plan.cache_clear()
    monkeypatch.setattr(tlq, "_device_clusters", lambda *a: 0)
    _meta_block("ffn", 1024, 8, F_=2048)
    assert meta_kernels == ["adaln_modulate_q8", "linear_q8", "quant_rows", "linear_q8"]
    assert _lib.launches["linear_q8_gelu_q8_pair"] == 2


def test_a_cuda_error_in_the_plan_is_not_a_refusal(meta_kernels, monkeypatch):
    def broken(*a):
        raise RuntimeError("attention_q8 clusters: CUDA error 700")

    monkeypatch.setattr(tattn, "attention_q8_clusters", broken)
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        _meta_block("sa", 1024, 8)
    assert meta_kernels == []
