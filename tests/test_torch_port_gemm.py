"""The host side of the port's GEMM kernels (``linear_epilogue`` with its
three routes, ``linear_q8``): the route and tile plan of every main-path
shape, the plan's agreement with the constants of ``csrc/gemm_sm90.cuh``,
and the ``ctypes`` argument types of every ``extern "C"`` launcher in
``csrc/*.cu``.

Nothing here needs a card or ``nvcc`` (the ragged route's copy-width rule
is compiled alone from ``csrc/linear.cu`` by the host C++ compiler): a plan
that the card would refuse
(too many blocks, too much shared memory, a box TMA cannot describe) and an
argument cut to 32 bits would otherwise show only on the card, where
``chip_smoke.py`` runs the kernels at these shapes.
"""

import ctypes
import glob
import importlib
import os
import re
import shutil
import subprocess

import pytest

from mixermdm_tpu_torch.ops import _lib

# The module, not the function ``ops.linear`` that the package exports.
lin = importlib.import_module("mixermdm_tpu_torch.ops.linear")

CSRC = _lib.CSRC_DIR
H100_SMS = 132
SMEM_227K = 227 * 1024

# (M, K, N, operand bytes, route).  M = 8 sequences x 299 frames for the
# block products and the dense layers beside them; 2 prompts x 77 tokens for
# the CLIP tower; M = 8 for the modulations and embeddings of the (B, E)
# embedding; K = 262 for motion_embed.
M = 8 * 299
MAIN_PATH_SHAPES = [
    # denoisers, E = 1024, F = 2048: QKV, CA Q and KV, out-proj, FFN
    (M, 1024, 3072, 2, "tma"), (M, 1024, 1024, 2, "tma"), (M, 1024, 2048, 2, "tma"),
    (M, 2048, 1024, 2, "tma"),
    # mixer, E = 512, F = 1024
    (M, 512, 1536, 2, "tma"), (M, 512, 512, 2, "tma"), (M, 512, 1024, 2, "tma"),
    (M, 1024, 512, 2, "tma"),
    # beside the blocks: final layer, influence head, CLIP c_fc / c_proj / in_proj
    (M, 1024, 262, 2, "tma"), (M, 512, 23, 2, "tma"), (154, 768, 3072, 2, "tma"),
    (154, 3072, 768, 2, "tma"), (154, 768, 2304, 2, "tma"),
    # the skinny layers
    (8, 1024, 2048, 2, "skinny"), (8, 512, 1024, 2, "skinny"), (8, 1024, 1024, 2, "skinny"),
    (8, 768, 1024, 2, "skinny"), (64, 1024, 3072, 2, "skinny"),
    # motion_embed: rows of 524 bytes; denoisers, mixer, discriminators (T = 300)
    (M, 262, 1024, 2, "ragged"), (M, 262, 512, 2, "ragged"), (8 * 300, 262, 256, 2, "ragged"),
    # the W8A8 block products
    (M, 1024, 3072, 1, "tma"), (M, 1024, 2048, 1, "tma"), (M, 2048, 1024, 1, "tma"),
    (M, 1024, 1024, 1, "tma"), (M, 512, 1536, 1, "tma"), (M, 512, 512, 1, "tma"),
    (M, 512, 1024, 1, "tma"), (M, 1024, 512, 1, "tma"),
]


def _plan(m, k, n, elem):
    """The plan the wrappers make for contiguous operands at 16-byte aligned
    addresses (what torch allocates)."""
    tma_ok = lin.tma_describable(elem, (0, k), (0, k))
    return lin.gemm_plan(m, n, k, tma_ok=tma_ok, skinny=elem == 2, sms=H100_SMS)


@pytest.mark.parametrize("m,k,n,elem,route", MAIN_PATH_SHAPES,
                         ids=[f"{'bf16' if e == 2 else 'int8'}-M{m}-K{k}-N{n}"
                              for m, k, n, e, _ in MAIN_PATH_SHAPES])
def test_main_path_shape_plan(m, k, n, elem, route):
    plan = _plan(m, k, n, elem)
    assert plan.route == route
    if route == "skinny":
        assert plan.grid == -(-n // lin.SKINNY_COLS)
        return
    tiles = -(-m // lin.BM) * -(-n // plan.bn)
    # A persistent grid of at most one block per SM, no block without a tile.
    assert plan.grid == min(tiles, H100_SMS) <= H100_SMS
    assert plan.bn in lin.TILE_BN
    # The ring fits the 227 KB a block may have, with 2-6 stages.
    assert 2 <= plan.stages <= lin.MAX_STAGES
    assert plan.smem == lin.smem_bytes(plan.bn, plan.stages) <= SMEM_227K
    # TMA boxes: 128 bytes deep (the 128-byte swizzle's span), at most 256 rows.
    assert lin.ROW_BYTES == 128 and lin.BM <= 256 and plan.bn <= 256
    # Every stage's x and w tiles start on the swizzle's 1024-byte period.
    assert (lin.BM * lin.ROW_BYTES) % 1024 == 0 and lin.stage_bytes(plan.bn) % 1024 == 0


def test_plan_fills_the_card_at_the_block_shapes():
    """The tile width chosen is the one that finishes soonest: no other width
    of TILE_BN needs fewer rounds of the persistent grid times its width."""
    for m, k, n, elem, route in MAIN_PATH_SHAPES:
        if route != "tma":
            continue
        plan = _plan(m, k, n, elem)

        def cost(bn):
            return -(-(-(-m // lin.BM) * -(-n // bn)) // H100_SMS) * (bn + lin.TILE_OVERHEAD)

        assert cost(plan.bn) == min(cost(bn) for bn in lin.TILE_BN)


@pytest.mark.parametrize("ld,ptr,elem,ok", [
    (1024, 0, 2, True), (262, 0, 2, False), (264, 0, 2, True), (1024, 8, 2, False),
    (1024, 0, 1, True), (1032, 0, 1, False), (1040, 16, 1, True)])
def test_tma_describable(ld, ptr, elem, ok):
    """16-byte aligned base and a row stride that is a multiple of 16 bytes."""
    assert lin.tma_describable(elem, (ptr, ld)) is ok


def test_unaligned_operands_take_the_ragged_route():
    assert lin.gemm_plan(M, 1024, 264, tma_ok=False).route == "ragged"
    assert lin.gemm_plan(8, 1024, 1024, tma_ok=False).route == "ragged"
    # K not a multiple of 64: the skinny route's 3-D view of a row would read
    # past its end; the TMA route zero-fills the K tail.
    assert lin.gemm_plan(8, 1024, 262, tma_ok=True).route == "tma"
    assert lin.gemm_plan(8, 1024, 520, tma_ok=True).route == "tma"
    assert lin.gemm_plan(8, 1024, 512, tma_ok=True).route == "skinny"


@pytest.fixture(scope="module")
def copy_width(tmp_path_factory):
    """``copy_width`` of ``csrc/linear.cu`` (host code: the ragged route's
    copy width in bytes for a bf16 matrix at ``ptr`` with row stride ``ld``
    elements), compiled alone by the host C++ compiler."""
    with open(os.path.join(CSRC, "linear.cu")) as f:
        m = re.search(r"^int copy_width\(const void\* p, long long ld\) \{\n.*?^\}\n", f.read(),
                      re.M | re.S)
    assert m, "copy_width not found in csrc/linear.cu"
    d = tmp_path_factory.mktemp("copy_width")
    (d / "copy_width.cpp").write_text('#include <cstdint>\nextern "C" ' + m.group(0))
    subprocess.run([shutil.which("c++") or "c++", "-shared", "-fPIC", "-o",
                    str(d / "copy_width.so"), str(d / "copy_width.cpp")], check=True)
    fn = ctypes.CDLL(str(d / "copy_width.so")).copy_width
    fn.argtypes, fn.restype = [ctypes.c_void_p, ctypes.c_int64], ctypes.c_int
    return fn


@pytest.mark.parametrize("n", [1024, 512, 256])
@pytest.mark.parametrize("ldx", [262, 524])
def test_ragged_plan_fills_the_card_in_one_wave(n, ldx, copy_width):
    """motion_embed, x rows of 524 bytes (a torch.cat of 262-wide rows) or
    1048 (the view x[..., :262] of 524-wide rows): the ragged route, one
    wave of persistent blocks at M = 2392 and 2400, every stage of K = 262
    in the ring at once, x copied 4 or 8 bytes at a time, w 4."""
    for m in (8 * 299, 8 * 300):
        plan = lin.gemm_plan(m, n, 262, tma_ok=lin.tma_describable(2, (0, ldx), (0, 262)),
                             sms=H100_SMS)
        tiles = -(-m // lin.BM) * -(-n // plan.bn)
        assert plan.route == "ragged"
        assert plan.grid == tiles <= H100_SMS
        assert plan.stages >= -(-262 // 64)
        assert plan.smem == lin.smem_bytes(plan.bn, plan.stages) <= SMEM_227K
    assert copy_width(0, ldx) == (4 if ldx == 262 else 8)
    assert copy_width(1 << 20, 262) == 4


@pytest.mark.parametrize("ptr,ld,width", [
    (0, 1024, 16), (8, 1024, 8), (0, 262, 4), (4, 524, 4), (0, 524, 8), (0, 263, 2),
    (2, 262, 2), (6, 1024, 2)])
def test_ragged_copy_width(ptr, ld, width, copy_width):
    """The widest copy every row start allows; 2-byte-aligned rows (an odd K
    or stride, or an odd 2-byte base) take element copies in the same kernel
    and still take the ragged route."""
    assert copy_width(ptr, ld) == width
    if width < 16:
        assert lin.gemm_plan(M, 1024, 263, tma_ok=lin.tma_describable(2, (ptr, ld))).route == \
            "ragged"


def _constexpr(text, name):
    m = re.search(rf"constexpr int {name} = ([^;]+);", text)
    assert m, name
    return m.group(1)


def test_plan_constants_match_the_kernel():
    """The Python plan and csrc/gemm_sm90.cuh describe one layout."""
    with open(os.path.join(CSRC, "gemm_sm90.cuh")) as f:
        src = f.read()
    assert int(_constexpr(src, "BM")) == lin.BM
    assert int(_constexpr(src, "kRowBytes")) == lin.ROW_BYTES
    assert int(_constexpr(src, "kSmemAlign")) == lin.SMEM_ALIGN
    assert int(_constexpr(src, "kSmemLimit")) == lin.SMEM_LIMIT == SMEM_227K
    stride, max_bn = int(_constexpr(src, "kEpiStride")), int(_constexpr(src, "kMaxBN"))
    assert lin.EPI_BYTES == 2 * (64 * stride + 2 * max_bn * 4)
    assert max(lin.TILE_BN) == max_bn
    assert "kSmemAlign + stages * stage_bytes(bn) + kEpiBytes + 2 * stages * 8" in src
    # Every tile width has a launch case and a wgmma of that width, both types.
    with open(os.path.join(CSRC, "wgmma.cuh")) as f:
        wgmma = f.read()
    for bn in lin.TILE_BN:
        assert f"case {bn}: return launch_bn<Acc, {bn}>" in src
        assert f"set_smem_limit<Acc, {bn}>()" in src
        assert f"void wgmma_bf16<{bn}>" in wgmma and f"m64n{bn}k16.f32.bf16.bf16" in wgmma
        assert f"void wgmma_s8<{bn}>" in wgmma and f"m64n{bn}k32.s32.s8.s8" in wgmma


_C_TYPES = {
    "const void*": ctypes.c_void_p, "void*": ctypes.c_void_p, "long long": ctypes.c_int64,
    "int": ctypes.c_int, "float": ctypes.c_float,
    "const long long*": ctypes.POINTER(ctypes.c_int64),
}


def _launchers():
    """{name: [C parameter types]} of every ``extern "C"`` function in csrc."""
    out = {}
    for path in sorted(glob.glob(os.path.join(CSRC, "*.cu"))):
        with open(path) as f:
            src = f.read()
        for m in re.finditer(r'extern "C" int (\w+)\(([^)]*)\)', src):
            params = [p.strip() for p in m.group(2).split(",") if p.strip()]
            types = []
            for p in params:
                t = re.match(r"(.*?)\s*\b(\w+)$", p).group(1).replace(" *", "*").strip()
                types.append(t)
            out[m.group(1)] = types
    return out


def test_every_launcher_has_argtypes():
    assert set(_launchers()) == set(_lib.ARGTYPES)
    assert set(_lib.INIT_FUNCTIONS) <= set(_lib.ARGTYPES)


@pytest.mark.parametrize("name", sorted(_lib.ARGTYPES))
def test_launcher_argtypes_match_the_source(name):
    """Each C parameter has its ctypes type: a c_void_p for every pointer
    (the stream too), c_int64 for ``long long``.  Without them ctypes would
    pass a Python int as 32 bits and cut a pointer or a descriptor."""
    c_types = _launchers()[name]
    assert len(c_types) == len(_lib.ARGTYPES[name])
    for c_type, py_type in zip(c_types, _lib.ARGTYPES[name]):
        assert c_type in _C_TYPES, c_type
        assert py_type == _C_TYPES[c_type], (name, c_type, py_type)


def test_launch_shapes_are_counted_beside_the_launches():
    _lib.reset_launch_counts()
    try:
        _lib.check_launch("linear_epilogue_skinny", 0, shape=(8, 1024, 2048, "none"))
        _lib.check_launch("linear_epilogue_skinny", 0, shape=(8, 1024, 2048, "none"))
        _lib.check_launch("quant_rows", 0)
        assert _lib.launches == {"linear_epilogue_skinny": 2, "quant_rows": 1}
        assert _lib.launch_shapes == {("linear_epilogue_skinny", 8, 1024, 2048, "none"): 2}
        with pytest.raises(RuntimeError, match="CUDA error 1"):
            _lib.check_launch("linear_epilogue", 1, shape=(1, 1, 1, "none"))
        assert _lib.launches["linear_epilogue"] == 0
    finally:
        _lib.reset_launch_counts()
    assert not _lib.launches and not _lib.launch_shapes


# ------------------------------------------- the quantising GELU product's plan

lq = importlib.import_module("mixermdm_tpu_torch.ops.linear_q8")


def _h100_clusters(nc, ctas, smem):
    """Clusters an H100 SXM holds at once, as cudaOccupancyMaxActiveClusters
    reported them (chip_smoke.py phase 3): 15 of 8 CTAs or fewer (one CTA
    to an SM), 13 at three warpgroups, 7 of 16 CTAs (one to a GPC)."""
    return 7 if ctas > 8 else (13 if nc == 3 else 15)


@pytest.mark.parametrize("m,k,n", [(M, 1024, 2048), (M, 512, 1024), (393, 1024, 1040)])
def test_gelu_q8_plan(m, k, n):
    """The FFN's first products (denoisers F = 2048, mixer F = 1024) and a
    ragged one: a cluster spans a row block's N-tiles, fits the card, and
    every cluster has a row block."""
    plan = lq.gelu_q8_plan(m, n, k, max_clusters=_h100_clusters)
    assert plan.cluster_ctas == -(-n // lq.GELU_Q8_BN) <= lq.MAX_CLUSTER_CTAS
    assert plan.nc in lq.GELU_Q8_WARPGROUPS and 2 <= plan.stages <= lin.MAX_STAGES
    assert plan.smem == lq.gelu_q8_smem_bytes(plan.nc, plan.stages) <= SMEM_227K
    assert 1 <= plan.clusters <= -(-m // (64 * plan.nc))
    if m == M:  # the main path: three warpgroups, the fewest rounds of row blocks
        assert plan.nc == 3 and -(-(-(-m // 192)) // plan.clusters) == (2 if n == 2048 else 1)


def test_gelu_q8_plan_refuses_what_no_cluster_spans():
    with pytest.raises(ValueError, match="more than 16 tiles"):
        lq.gelu_q8_plan(M, 2049, 1024, max_clusters=_h100_clusters)
    with pytest.raises(RuntimeError, match="no cluster"):
        lq.gelu_q8_plan(M, 2048, 1024, max_clusters=lambda *a: 0)


def test_gelu_q8_constants_match_the_kernel():
    with open(os.path.join(CSRC, "gemm_sm90.cuh")) as f:
        src = f.read()
    assert int(_constexpr(src, "kGeluQ8BN")) == lq.GELU_Q8_BN
    assert int(_constexpr(src, "kMaxClusterCtas")) == lq.MAX_CLUSTER_CTAS
    assert ("kSmemAlign + stages * gelu_q8_stage_bytes(nc, bn) + nc * (kEpiWgBytes + 2 * 64 * 4) +"
            in src)
    with open(os.path.join(CSRC, "linear_q8.cu")) as f:
        launcher = f.read()
    for nc in lq.GELU_Q8_WARPGROUPS:
        assert f"return launch_gelu_q8<{nc}>" in launcher
        assert f"set_gelu_q8_attributes<{nc}>()" in launcher
    assert "cudaFuncAttributeNonPortableClusterSizeAllowed" in launcher


def test_sa_block_launchers_have_argtypes():
    """The launchers, occupancy queries and init functions of the one-launch
    SA blocks are parsed from their two sources and bound (checked type by
    type above)."""
    files = {}
    for path in sorted(glob.glob(os.path.join(CSRC, "*.cu"))):
        with open(path) as f:
            for m in re.finditer(r'extern "C" int (\w+)\(', f.read()):
                files[m.group(1)] = os.path.basename(path)
    for name in ("mm_sa_block", "mm_sa_block_occupancy", "mm_sa_block_init"):
        assert files[name] == "sa_block.cu" and name in _lib.ARGTYPES
    for name in ("mm_sa_block_i8x", "mm_sa_block_i8x_occupancy", "mm_sa_block_i8x_init"):
        assert files[name] == "sa_block_i8x.cu" and name in _lib.ARGTYPES
    assert {"sa_block.cu", "sa_block_i8x.cu"} <= set(_lib.SOURCES)


def test_fused_quant_launchers_have_argtypes():
    """The launchers of attention_q8 and of the quantising GELU product, and
    their occupancy queries, are bound (checked type by type above)."""
    new = {"mm_attention_q8", "mm_attention_q8_clusters", "mm_linear_q8_gelu_q8",
           "mm_linear_q8_gelu_q8_clusters"}
    assert new <= set(_launchers()) and new <= set(_lib.ARGTYPES)
    assert _lib.ARGTYPES["mm_attention_q8"][4] == ctypes.POINTER(ctypes.c_int64)
