"""repro_torch.kernels against the JAX reference repro.kernels.

On the CPU, ``ops.flash_attention`` runs the kernel's plain version
(``repro_torch.kernels.ref.reference_attention``); both are held against
``repro.kernels.ref.reference_attention`` and, for a few cases, against the
Pallas kernel ``repro.kernels.flash_attention.flash_attention`` run in
interpret mode.  Inputs are numpy draws from a seed.  Tolerances as in
tests/test_kernels.py: float32 2e-5, bfloat16 2e-2.  The CUDA kernel itself
is held against its plain version in tests/test_torch_cuda.py.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro.kernels.ref import reference_attention as jax_reference

from repro_torch.kernels import _build, ops
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import mlstm_scan as ms
from repro_torch.kernels.ref import reference_attention

TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The plain versions run on one thread: the suite runs several test
    processes on the CPU at once, and torch's thread pool competing across
    them slows them all."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

# name: (b, t, s, h, kvh, d, q_pos, causal, window); q_pos None = arange(t),
# "tail" = the last t of s positions (queries over a cache prefix).
CASES = {
    "mha_square": (1, 128, 128, 2, 2, 64, "tail", True, 0),
    "gqa2_cache_extended": (2, 128, 256, 4, 2, 64, "tail", True, 0),
    "mqa_d128": (1, 256, 256, 4, 1, 128, "tail", True, 0),
    "padding_path": (2, 96, 160, 4, 2, 64, "tail", True, 0),
    "tiny_d32": (1, 8, 8, 2, 2, 32, "tail", True, 0),
    "gqa3_d128_odd": (2, 67, 67, 6, 2, 128, None, True, 0),
    "gqa3_d16_odd_tail": (1, 33, 70, 6, 2, 16, "tail", True, 0),
    "window1": (2, 128, 128, 4, 2, 64, None, True, 1),
    "window7": (2, 128, 128, 4, 2, 64, None, True, 7),
    "window64": (2, 128, 128, 4, 2, 64, None, True, 64),
    "window1000": (2, 128, 128, 4, 2, 64, None, True, 1000),
    "gqa3_window5": (1, 45, 45, 6, 2, 32, None, True, 5),
    "noncausal": (1, 64, 96, 2, 2, 64, None, False, 0),
    "noncausal_gqa3_window": (1, 20, 50, 3, 1, 16, "tail", False, 9),
    "decode": (4, 1, 512, 8, 2, 64, [511], True, 0),
    "decode_gqa3_d128": (2, 1, 200, 6, 2, 128, [130], True, 0),
    "decode_window": (2, 1, 200, 6, 2, 32, [150], True, 40),
    "fully_masked_rows": (1, 16, 32, 2, 2, 32, [-5] * 16, True, 0),
    "some_rows_masked": (1, 16, 32, 6, 2, 32, list(range(-8, 8)), True, 0),
    # head dim 256 (gemma3-1b: H4 KV1, a 512-key window on local layers)
    "prefill_tail_d256": (1, 37, 70, 4, 1, 256, "tail", True, 0),
    "decode_d256": (2, 1, 90, 4, 1, 256, [70], True, 0),
    "window7_d256": (1, 70, 70, 4, 1, 256, None, True, 7),
    "gqa4_d256": (2, 33, 33, 8, 2, 256, None, True, 0),
}
# Interpret mode runs the Pallas kernel body in Python: keep these few.
PALLAS_CASES = ["gqa3_d128_odd", "gqa3_window5", "noncausal_gqa3_window",
                "decode_gqa3_d128", "some_rows_masked", "window7_d256"]


def _inputs(name, dtype):
    b, t, s, h, kvh, d, q_pos, causal, window = CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    arrs = [rng.normal(size=shape).astype(np.float32)
            for shape in ((b, t, h, d), (b, s, kvh, d), (b, s, kvh, d))]
    torch_qkv = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs]
    jax_qkv = [jnp.asarray(x.float().numpy(), dtype) for x in torch_qkv]
    if q_pos == "tail":
        q_pos = list(range(s - t, s))
    if q_pos is None:
        q_pos = list(range(t))
    pos = np.asarray(q_pos, np.int32)
    kw = dict(causal=causal, window=window)
    return (torch_qkv, dict(kw, q_pos=torch.from_numpy(pos)),
            jax_qkv, dict(kw, q_pos=jnp.asarray(pos)))


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_attention_matches_reference(name, dtype):
    """repro_torch reference_attention and ops.flash_attention (CPU) vs
    repro.kernels.ref.reference_attention."""
    tq, tkw, jq, jkw = _inputs(name, dtype)
    want = _f32(jax_reference(*jq, **jkw))
    got = reference_attention(*tq, **tkw)
    assert got.dtype == tq[0].dtype and got.shape == tq[0].shape
    np.testing.assert_allclose(_f32(got), want, **TOL[dtype])
    np.testing.assert_allclose(_f32(ops.flash_attention(*tq, **tkw)), want,
                               **TOL[dtype])


@pytest.mark.parametrize("name", PALLAS_CASES)
def test_plain_attention_matches_pallas_kernel(name):
    """repro_torch ops.flash_attention (CPU) vs the Pallas kernel
    repro.kernels.flash_attention.flash_attention(interpret=True)."""
    tq, tkw, jq, jkw = _inputs(name, "float32")
    want = _f32(pallas_flash(*jq, **jkw, block_q=32, block_k=32,
                             interpret=True))
    np.testing.assert_allclose(_f32(ops.flash_attention(*tq, **tkw)), want,
                               **TOL["float32"])


def test_fully_masked_rows_are_zero():
    tq, tkw, _, _ = _inputs("fully_masked_rows", "float32")
    assert not ops.flash_attention(*tq, **tkw).any()
    tq, tkw, _, _ = _inputs("some_rows_masked", "float32")
    out = ops.flash_attention(*tq, **tkw)
    assert not out[:, :8].any() and out[:, 8:].abs().min() > 0


def test_kernel_wrapper_refuses_cpu_tensors():
    """The CUDA wrapper never falls back: CPU tensors go through ops."""
    tq, tkw, _, _ = _inputs("tiny_d32", "float32")
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention(*tq, **tkw)


def test_build_is_keyed_on_the_source(tmp_path, monkeypatch):
    """The key covers the source and every shared header csrc/*.cuh, so
    an edited header rebuilds every source that may include it."""
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    src = tmp_path / "k.cu"
    src.write_text("// one\n")
    first = _build.library_path("k")
    src.write_text("// two\n")
    second = _build.library_path("k")
    assert second != first
    assert second.name.startswith("k-")
    header = tmp_path / "shared.cuh"
    header.write_text("// a\n")
    third = _build.library_path("k")
    assert third != second
    header.write_text("// b\n")
    assert _build.library_path("k") not in (second, third)
    header.unlink()
    assert _build.library_path("k") == second


def test_build_without_nvcc_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "CUDA_NVCC", str(tmp_path / "nvcc"))
    (tmp_path / "k.cu").write_text("// k\n")
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build_all()


# The wrapper's plan: which kernel, tiles, splits and scratch a call gets.
# Pure Python, so it is tested here; the kernels it picks run on the card
# (tests/test_torch_cuda.py).
PLAN_SHAPES = [  # (b, t, s, h, kvh, d)
    (4, 512, 512, 24, 8, 128),     # llama3.2-3b prefill
    (4, 1, 1024, 24, 8, 128),      # llama3.2-3b decode step
    (2, 16, 300, 6, 2, 128), (2, 17, 300, 6, 2, 128),
    (1, 1, 2048, 4, 1, 128), (1, 16, 200, 16, 2, 64),
    (3, 8, 257, 8, 2, 32), (2, 1, 40, 6, 2, 64), (1, 90, 90, 16, 2, 64),
    (2, 150, 150, 4, 4, 16), (1, 1, 100_000, 32, 8, 128),
    # head dim 256: gemma3-1b's prefill, decode step and training shape;
    # decode rows of a group over 1, 2 and 4 chunks; G = 64 in prefill
    (4, 512, 512, 4, 1, 256), (4, 1, 1024, 4, 1, 256),
    (2, 1024, 1024, 4, 1, 256), (2, 16, 300, 6, 2, 256),
    (1, 16, 200, 16, 2, 256), (2, 8, 257, 8, 2, 256), (1, 40, 70, 64, 1, 256),
    # starcoder2-3b (G = 12): prefill, decode step, training shape
    (4, 512, 512, 24, 2, 128), (4, 1, 1024, 24, 2, 128),
    (2, 1024, 1024, 24, 2, 128),
]
# (position, head) rows of a prefill block, of a decode block at most and
# of an fp32 tensor-core block, by head dim.
PREFILL_ROWS = {16: 192, 32: 192, 64: 192, 128: 192, 256: 64}
DECODE_ROWS = {16: 64, 32: 64, 64: 64, 128: 64, 256: 32}
FP32_TC_ROWS = {16: 128, 32: 128, 64: 128, 128: 128, 256: 64}


@pytest.mark.parametrize("shape", PLAN_SHAPES)
def test_plan_fp32_always_takes_the_fma_kernel(shape):
    """Every fp32 call, decode steps too, takes the tensor-core kernel (the
    FMA kernel takes none): one block per (batch, KV head, tile of
    positions) holds all G heads of the group, positions x G <= its
    rows."""
    b, t, s, h, kvh, d = shape
    p = fa.plan(b, t, s, h, kvh, d, torch.float32)
    g = h // kvh
    assert p.path == "fp32_tc" and p.scratch == ()
    assert p.block_q == FP32_TC_ROWS[d] // g
    assert p.blocks == b * kvh * -(-t // p.block_q)


@pytest.mark.parametrize("shape", PLAN_SHAPES)
def test_plan_bf16_decodes_up_to_t16_and_prefills_above(shape):
    b, t, s, h, kvh, d = shape
    p = fa.plan(b, t, s, h, kvh, d, torch.bfloat16)
    assert p.path == ("decode" if t <= 16 else "prefill")
    if p.path == "prefill":
        # one block holds every query head of its KV group
        g = h // kvh
        assert p.block_q * g <= PREFILL_ROWS[d] and p.block_q >= 1
        assert p.block_q == PREFILL_ROWS[d] // g
        assert p.blocks == b * kvh * -(-t // p.block_q)


def test_plan_switches_kernels_between_t16_and_t17():
    assert fa.plan(2, 16, 300, 6, 2, 128, torch.bfloat16).path == "decode"
    assert fa.plan(2, 17, 300, 6, 2, 128, torch.bfloat16).path == "prefill"
    assert fa.plan(4, 512, 512, 24, 8, 128, torch.bfloat16).block_q == 64


def test_plan_serving_decode_fills_the_card():
    """llama3.2-3b's decode step: at least two blocks per SM of the H100."""
    p = fa.plan(4, 1, 1024, 24, 8, 128, torch.bfloat16)
    assert p.path == "decode" and p.blocks >= 2 * fa.H100_SMS
    assert (p.splits, p.tiles_per_split, p.blocks) == (16, 1, 512)


@pytest.mark.parametrize("shape", [x for x in PLAN_SHAPES if x[1] <= 16])
def test_plan_scratch_covers_every_row_and_split(shape):
    b, t, s, h, kvh, d = shape
    p = fa.plan(b, t, s, h, kvh, d, torch.bfloat16)
    assert p.scratch == (p.splits, b * t * h, d + 2)
    # the splits cover every key tile and none is empty
    tiles = -(-s // fa.KEY_TILE)
    assert (p.splits - 1) * p.tiles_per_split < tiles
    assert p.splits * p.tiles_per_split >= tiles
    # the row chunks cover the G x T rows of a KV group
    g = h // kvh
    assert (p.row_chunks - 1) * DECODE_ROWS[d] < g * t
    assert p.row_chunks * DECODE_ROWS[d] >= g * t
    assert p.blocks == b * kvh * p.splits * p.row_chunks


def test_plan_at_twelve_query_heads_a_kv_head():
    """starcoder2-3b, H24 KV2 D128: a prefill block holds 16 positions x 12
    heads (192 rows), also when the call wants the lse (training); a decode
    step's 12 rows of a group fit one chunk, and with two KV heads every
    key tile is a split of its own: 128 blocks, fewer than the 132 SMs."""
    for t, lse in ((512, False), (1024, True), (1, True)):
        p = fa.plan(4, t, 1024, 24, 2, 128, torch.bfloat16, lse=lse)
        assert p.path == "prefill" and p.block_q == 16
        assert p.blocks == 4 * 2 * -(-t // 16)
    p = fa.plan(4, 1, 1024, 24, 2, 128, torch.bfloat16)
    assert p.path == "decode" and p.row_chunks == 1
    assert (p.splits, p.tiles_per_split, p.blocks) == (16, 1, 128)


def test_plan_refuses_a_group_larger_than_a_prefill_block():
    with pytest.raises(ValueError, match="prefill"):
        fa.plan(1, 64, 64, 2 * fa.PREFILL_ROWS, 1, 64, torch.bfloat16)


@pytest.mark.parametrize("g", [1, 2, 3, 4, 8, 16, 33, 64])
def test_plan_prefill_rows_at_d256(g):
    """At head dim 256 a prefill block holds 64 (position, head) rows, not
    192: positions x G <= 64, as many positions as fit."""
    for lse in (False, True):
        p = fa.plan(2, 300, 300, 2 * g, 2, 256, torch.bfloat16, lse=lse)
        assert p.path == "prefill" and p.block_q == 64 // g
        assert p.block_q * g <= 64 < (p.block_q + 1) * g
        assert p.blocks == 2 * 2 * -(-300 // p.block_q)


def test_plan_refuses_a_group_above_64_at_d256():
    """G = 65 fits a block at head dim 128 (192 rows) but not at 256."""
    assert fa.plan(1, 64, 64, 65, 1, 128, torch.bfloat16).path == "prefill"
    with pytest.raises(ValueError, match="prefill.*256"):
        fa.plan(1, 64, 64, 65, 1, 256, torch.bfloat16)
    with pytest.raises(ValueError, match="prefill"):
        fa.plan(1, 1, 64, 65, 1, 256, torch.bfloat16, lse=True)


@pytest.mark.parametrize("g,t,chunks", [(4, 1, 1), (32, 1, 1), (33, 1, 2),
                                        (3, 16, 2), (8, 16, 4), (4, 8, 1),
                                        (16, 16, 8)])
def test_plan_decode_row_chunks_at_d256(g, t, chunks):
    """At head dim 256 a decode block holds at most 32 of the G x T rows
    of a KV group (64 below): the chunks cover every row, each full but
    the last, and every chunk of every split is a block."""
    b, s, kvh = 2, 700, 2
    p = fa.plan(b, t, s, g * kvh, kvh, 256, torch.bfloat16)
    assert p.path == "decode" and p.row_chunks == chunks
    assert (chunks - 1) * 32 < g * t <= chunks * 32
    assert p.blocks == b * kvh * p.splits * chunks
    assert p.scratch == (p.splits, b * t * g * kvh, 258)
    at_128 = fa.plan(b, t, s, g * kvh, kvh, 128, torch.bfloat16)
    assert at_128.row_chunks == -(-g * t // 64)


@pytest.mark.parametrize("t,bq", [(1, 16), (16, 16), (17, 16), (512, 16),
                                  (1024, 16)])
def test_plan_fp32_block_q_at_d256(t, bq):
    """At head dim 256 (G = 4) an fp32 tensor-core block holds 64 rows, 16
    positions of the group's 4 heads, where D <= 128 holds 128 rows (32
    positions), whatever T is."""
    p = fa.plan(2, t, 1024, 4, 1, 256, torch.float32)
    assert p.path == "fp32_tc" and p.block_q == bq
    assert p.blocks == -(-t // bq) * 2 * 1
    assert fa.plan(2, t, 1024, 4, 1, 128, torch.float32).block_q == 32


# The mLSTM scan's plan: which kernel and grid a call gets, and the scratch
# of the tensor-core path.  Pure Python, so it is tested here; the kernels
# it picks run on the card (tests/test_torch_cuda.py).
MLSTM_PLAN_SHAPES = [  # (b, t, h, d, chunk)
    (4, 512, 4, 512, 256),         # xlstm-350m prefill
    (1, 1024, 2, 512, 256), (1, 1024, 1, 512, 64), (2, 512, 2, 512, 256),
    (1, 64, 1, 16, 16), (1, 96, 2, 32, 48), (1, 128, 2, 48, 32),
    (2, 256, 2, 64, 64), (1, 256, 2, 128, 128), (1, 64, 2, 64, 16),
    (1, 96, 2, 32, 24), (2, 4, 2, 16, 1),
]


@pytest.mark.parametrize("shape", MLSTM_PLAN_SHAPES)
@pytest.mark.parametrize("has_state", [False, True])
def test_mlstm_plan_fp32_takes_the_split_kernel_iff_chunk_is_a_multiple_of_16(
        shape, has_state):
    """fp32 calls whose chunk (and D) is a multiple of 16 take the split
    tensor-core kernel, two launches with the scratch of the chunk states;
    the others the FMA kernel, one launch and no scratch."""
    b, t, h, d, chunk = shape
    p = ms.plan(b, t, h, d, chunk, torch.float32, has_state)
    if chunk % 16:
        assert p.path == "fma" and p.boundary == () and len(p.blocks) == 1
    else:
        assert p.path == "tc_f32" and len(p.blocks) == 2
        # the state pass as bf16's; the output pass in blocks of 64 rows
        assert p.blocks == (ms.plan(b, t, h, d, chunk, torch.bfloat16,
                                    has_state).blocks[0],
                            -(-chunk // 64) * (t // chunk) * b * h
                            * -(-d // 128))


@pytest.mark.parametrize("shape", MLSTM_PLAN_SHAPES)
def test_mlstm_plan_bf16_takes_the_tc_kernel_iff_chunk_is_a_multiple_of_16(
        shape):
    b, t, h, d, chunk = shape
    p = ms.plan(b, t, h, d, chunk, torch.bfloat16)
    assert p.path == ("tc" if chunk % 16 == 0 else "fma")
    assert len(p.blocks) == (2 if p.path == "tc" else 1)


def test_mlstm_plan_serving_shape_fills_the_card():
    """xlstm-350m's prefill scan takes the tensor-core kernel, and each of
    its two passes has at least 128 blocks for the H100's 132 SMs."""
    p = ms.plan(4, 512, 4, 512, 256, torch.bfloat16)
    assert p.path == "tc"
    assert all(n >= 128 for n in p.blocks)
    assert p.blocks == (256, 256)


def test_mlstm_plan_chunk24_bf16_takes_the_fma_kernel():
    assert ms.plan(1, 96, 2, 32, 24, torch.bfloat16).path == "fma"
    assert ms.plan(1, 96, 2, 32, 32, torch.bfloat16).path == "tc"


@pytest.mark.parametrize("nc", [1, 2, 4, 16])
@pytest.mark.parametrize("has_state", [False, True])
def test_mlstm_plan_scratch_covers_the_chunk_states(nc, has_state):
    """One C (hi and lo terms) for each chunk that carries a state in: every
    chunk but the first, and the first too with an initial state; none for
    a single chunk from zero."""
    b, h, d, chunk = 2, 3, 64, 64
    p = ms.plan(b, nc * chunk, h, d, chunk, torch.bfloat16, has_state)
    states = nc - 1 + int(has_state)
    assert p.boundary == ((states, b * h, 2, d, d) if states else ())


@pytest.mark.parametrize("nc", [1, 2, 4, 16])
@pytest.mark.parametrize("has_state", [False, True])
def test_mlstm_plan_fp32_scratch_holds_three_terms(nc, has_state):
    """The split kernel's scratch: one C a chunk that carries a state in,
    as three bf16 terms (their sum is the fp32 C exactly), so that the
    output pass reads C0 with no split."""
    b, h, d, chunk = 2, 3, 64, 64
    p = ms.plan(b, nc * chunk, h, d, chunk, torch.float32, has_state)
    states = nc - 1 + int(has_state)
    assert ms.C_PARTS_F32 == 3
    assert p.boundary == ((states, b * h, 3, d, d) if states else ())


def test_mlstm_counts_launches_by_path():
    assert set(ms.launches_by_path) == {"fma", "tc", "tc_f32"}
    assert isinstance(ms.launches, int)


@pytest.mark.parametrize("shape", PLAN_SHAPES)
def test_plan_never_sends_a_call_that_needs_lse_to_decode(shape):
    """The decode kernel writes no log-sum-exp: a bf16 call that asks for
    it takes the prefill kernel whatever its T; fp32 takes its kernel
    either way."""
    b, t, s, h, kvh, d = shape
    p = fa.plan(b, t, s, h, kvh, d, torch.bfloat16, lse=True)
    g = h // kvh
    assert p.path == "prefill" and p.block_q == PREFILL_ROWS[d] // g
    assert fa.plan(b, t, s, h, kvh, d, torch.float32, lse=True) == \
        fa.plan(b, t, s, h, kvh, d, torch.float32)


def test_kernel_wrappers_refuse_grad_before_anything_else():
    """A kernel's output is a tensor autograd cannot see, so the wrappers
    raise when grad mode is on and an input requires grad, before the
    device check (this CPU tensor would otherwise be refused for its
    device); under no_grad the device check is what refuses it."""
    tq, tkw, _, _ = _inputs("tiny_d32", "float32")
    q = tq[0].clone().requires_grad_(True)
    with pytest.raises(RuntimeError, match="autograd"):
        fa.flash_attention(q, *tq[1:], **tkw)
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention(q, *tq[1:], **tkw)
    x = torch.zeros((1, 16, 1, 16), requires_grad=True)
    gate = torch.zeros((1, 16, 1))
    with pytest.raises(RuntimeError, match="autograd"):
        ms.mlstm_scan(x, x, x, gate, gate, chunk=16)
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA"):
        ms.mlstm_scan(x, x, x, gate, gate, chunk=16)


@pytest.mark.parametrize("name", ["gqa3_d128_odd", "window7", "noncausal",
                                  "some_rows_masked"])
def test_plain_attention_lse_matches_reference_logsumexp(name):
    """ops.flash_attention(return_lse=True) on the CPU: the log-sum-exp of
    each row's visible scaled scores, from repro.kernels.ref's logits, and
    1e30 where a row sees nothing; o unchanged."""
    tq, tkw, _, _ = _inputs(name, "float32")
    o, lse = ops.flash_attention(*tq, **tkw, return_lse=True)
    assert torch.equal(o, ops.flash_attention(*tq, **tkw))
    b, t, h, d = tq[0].shape
    s, kvh = tq[1].shape[1], tq[1].shape[2]
    qp = tkw["q_pos"].numpy()
    kp = np.arange(s)
    ok = kp[None, :] >= 0
    if tkw["causal"]:
        ok = ok & (kp[None, :] <= qp[:, None])
    if tkw["window"] > 0:
        ok = ok & (qp[:, None] - kp[None, :] < tkw["window"])
    qg = tq[0].numpy().astype(np.float64).reshape(b, t, kvh, h // kvh, d)
    logits = np.einsum("btkgd,bskd->bkgts", qg,
                       tq[1].numpy().astype(np.float64)) / np.sqrt(d)
    logits = np.where(ok, logits, -np.inf)
    mx = logits.max(-1, keepdims=True)
    want = (np.log(np.exp(logits - np.where(np.isfinite(mx), mx, 0)).sum(-1))
            + np.where(np.isfinite(mx[..., 0]), mx[..., 0], 0))
    want = np.where(ok.any(-1), want, 1e30).reshape(b, h, t)
    np.testing.assert_allclose(lse.numpy(), want, rtol=1e-5, atol=1e-5)
