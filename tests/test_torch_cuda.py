"""The port on the card: the CUDA flash-attention and mLSTM chunk-scan
kernels against their plain versions, the flash-attention autograd
Function and its log-sum-exp, the models on the card against the models on
the CPU (serving and training), and the cycle engine's CUDA graphs (kept
across calls: hits, refills and evictions) against the CPU.

Every test here is marked ``cuda`` and skips where there is no GPU.  This
file imports neither jax nor repro, so it runs where only the port is
installed:  PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
Tolerances as in tests/test_kernels.py: attention float32 2e-5 and
bfloat16 2e-2; mLSTM float32 rtol 5e-4 atol 5e-5 and bfloat16 5e-2.
"""
import dataclasses
import functools
import importlib.util
import os

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import mlstm_scan as ms
from repro_torch.kernels.ref import (reference_attention, reference_mlstm_scan,
                                     reference_mlstm_scan_float64)
from repro_torch.models import get_config, init_params
from repro_torch.models import transformer as TT

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}

# name: (b, t, s, h, kvh, d, q_pos, causal, window); q_pos None = arange(t),
# "tail" = the last t of s positions.
CASES = {
    "gqa3_d128_odd": (2, 131, 131, 6, 2, 128, None, True, 0),
    "gqa3_d16_odd_tail": (2, 37, 101, 6, 2, 16, "tail", True, 0),
    "gqa2_d32": (2, 100, 100, 4, 2, 32, None, True, 0),
    "mqa_d64_tail": (1, 200, 333, 4, 1, 64, "tail", True, 0),
    "window7": (2, 150, 150, 6, 2, 64, None, True, 7),
    "window64_d128": (2, 150, 150, 6, 2, 128, None, True, 64),
    "noncausal": (1, 70, 190, 6, 2, 128, None, False, 0),
    "noncausal_window": (1, 70, 190, 3, 1, 64, "tail", False, 33),
    "decode_1024": (4, 1, 1024, 24, 8, 128, [700], True, 0),
    "decode_window": (4, 1, 1024, 24, 8, 128, [700], True, 100),
    "decode_t16": (2, 16, 300, 6, 2, 128, "tail", True, 0),
    "fully_masked_rows": (1, 16, 40, 6, 2, 128, [-5] * 16, True, 0),
    "some_rows_masked": (2, 80, 80, 6, 2, 64, list(range(-40, 40)), True, 0),
    # bf16 switches from the decode kernel (T <= 16) to the prefill kernel
    "prefill_t17": (2, 17, 300, 6, 2, 128, "tail", True, 0),
    "decode_t2_d64": (2, 2, 200, 6, 2, 64, "tail", True, 0),
    "decode_t8_gqa4_d32": (3, 8, 257, 8, 2, 32, "tail", True, 0),
    # group sizes G = H/KV of 1, 4 and 8, prefill and decode
    "mha_g1_d64": (2, 150, 150, 4, 4, 64, None, True, 0),
    "decode_g1": (2, 1, 300, 4, 4, 128, [250], True, 0),
    "gqa4_d128_tail": (1, 100, 140, 8, 2, 128, "tail", True, 0),
    "gqa8_d64": (1, 90, 90, 16, 2, 64, None, True, 0),
    # G = 8 at qwen3-moe-30b-a3b's head shape (H32 KV4 D128): prefill
    # blocks of 24 positions x 8 heads, and its decode
    "gqa8_d128_qwen3": (2, 200, 200, 32, 4, 128, None, True, 0),
    "decode_gqa8_d128_qwen3": (4, 1, 1024, 32, 4, 128, [527], True, 0),
    "decode_gqa8_t16": (1, 16, 200, 16, 2, 64, "tail", True, 0),
    # D = 16 on the tensor cores, and S below one 64-key tile
    "d16_gqa4": (2, 70, 70, 8, 2, 16, None, True, 0),
    "decode_d16": (2, 1, 100, 6, 2, 16, [77], True, 0),
    "s_below_tile": (2, 40, 40, 6, 2, 128, None, True, 0),
    "decode_s_below_tile": (2, 1, 40, 6, 2, 64, [30], True, 0),
    # a window edge inside a split, a decode row that sees nothing (every
    # split empty), one (batch, KV head) over many splits
    "decode_window_edge": (2, 1, 1024, 6, 2, 128, [700], True, 97),
    "decode_all_masked": (2, 1, 512, 6, 2, 128, [-3], True, 0),
    "decode_bkv1": (1, 1, 2048, 4, 1, 128, [1500], True, 0),
    # head dim 256 (gemma3-1b: H4 KV1, local layers windowed at 512): the
    # prefill kernel's two-warpgroup instance, decode blocks of 32 rows
    # (G x T = 48 and 128 rows: 2 and 4 chunks), the fp32 kernel's BQ 32
    "mqa_d256": (2, 150, 150, 4, 1, 256, None, True, 0),
    "mqa_d256_window_tail": (1, 100, 700, 4, 1, 256, "tail", True, 512),
    "gqa3_d256_odd": (2, 131, 131, 6, 2, 256, None, True, 0),
    "noncausal_d256": (1, 70, 190, 6, 2, 256, None, False, 0),
    "decode_d256_window": (4, 1, 1024, 4, 1, 256, [527], True, 512),
    "decode_t16_d256": (2, 16, 300, 6, 2, 256, "tail", True, 0),
    "decode_gqa8_t16_d256": (1, 16, 200, 16, 2, 256, "tail", True, 0),
    "fully_masked_rows_d256": (1, 16, 40, 4, 1, 256, [-5] * 16, True, 0),
    # G = 5 (hymba-1.5b, H25 KV5 D64): prefill blocks of 38 positions, 190
    # of the 192 rows used; G = 6 (internvl2-26b, H48 KV8 D128): 32
    # positions; at D 64 and 128, prefill and decode, windows that bind
    "gqa5_d64_window": (2, 300, 300, 10, 2, 64, None, True, 100),
    "gqa5_d128_window_tail": (1, 200, 500, 10, 2, 128, "tail", True, 128),
    "gqa6_d128_window": (2, 300, 300, 12, 2, 128, None, True, 100),
    "gqa6_d64_window_tail": (1, 150, 400, 12, 2, 64, "tail", True, 64),
    "decode_gqa5_window": (4, 1, 1024, 25, 5, 64, [700], True, 100),
    "decode_gqa5_d128_t8": (2, 8, 700, 10, 2, 128, "tail", True, 300),
    "decode_gqa6_window": (4, 1, 1024, 48, 8, 128, [700], True, 100),
    "decode_gqa6_d64_t4": (2, 4, 600, 12, 2, 64, "tail", True, 64),
    # whisper-base (H8 KV8 D64): the encoder, non-causal at T = S = 1500
    # (S not a multiple of the 64-key tile), and cross-attention, queries
    # at position 0 against 1500 keys, at prefill (T 512) and decode (T 1)
    "noncausal_t1500": (1, 1500, 1500, 8, 8, 64, None, False, 0),
    "cross_t512_s1500": (2, 512, 1500, 8, 8, 64, [0] * 512, False, 0),
    "cross_decode_s1500": (4, 1, 1500, 8, 8, 64, [0], False, 0),
    # the fp32 tensor-core kernel's hazards: rows of q and k whose entries
    # span 1e-3 to 1e3 (reciprocal column scales, so scores stay O(1)) and
    # v's columns from 1 to 1e-6, at D 64 and 256; G = 5 with T not a
    # multiple of its blocks (25 positions at D <= 128, 12 at D = 256);
    # queries at positions 300-339 of a 1024-slot cache filled to 339
    "wide_range_d64": (2, 150, 150, 6, 2, 64, None, True, 0),
    "wide_range_d256": (1, 100, 100, 4, 1, 256, None, True, 0),
    "gqa5_d256_odd_t": (1, 77, 77, 10, 2, 256, None, True, 0),
    "gqa5_d16_window": (2, 131, 131, 10, 2, 16, None, True, 20),
    "cache_past_fill": (2, 40, 1024, 6, 2, 128, list(range(300, 340)), True,
                        0),
    # the training shapes of hymba-1.5b (G 5 D 64: 1024-key windows, and a
    # 256-key window that binds at T 640), internvl2-26b (G 6 D 128) and
    # whisper-base (its encoder at T = S = 1500, its cross-attention: 1024
    # queries at position 0 against 1500 keys), where the lse path runs
    "train_gqa5_window1024": (2, 1024, 1024, 25, 5, 64, None, True, 1024),
    "train_gqa5_t640_window256": (2, 640, 640, 25, 5, 64, None, True, 256),
    "train_gqa6_d128": (2, 1024, 1024, 48, 8, 128, None, True, 0),
    "train_noncausal_t1500": (2, 1500, 1500, 8, 8, 64, None, False, 0),
    "train_cross_t1024_s1500": (2, 1024, 1500, 8, 8, 64, [0] * 1024, False,
                                0),
}
#: The lse path's hazard shapes of the models trained with a prefix or an
#: encoder.
TRAIN_LSE_CASES = ["train_gqa5_window1024", "train_gqa5_t640_window256",
                   "train_gqa6_d128", "train_noncausal_t1500",
                   "train_cross_t1024_s1500"]
ALL_MASKED = ("fully_masked_rows", "decode_all_masked",
              "fully_masked_rows_d256")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(name, dtype, device):
    b, t, s, h, kvh, d, q_pos, causal, window = CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    qkv = [rng.normal(size=shape).astype(np.float32)
           for shape in ((b, t, h, d), (b, s, kvh, d), (b, s, kvh, d))]
    if name.startswith("wide_range"):
        span = (10.0 ** np.linspace(-3, 3, d)).astype(np.float32)
        qkv = [qkv[0] * span, qkv[1] / span, qkv[2] * span[::-1] / 1e3]
    qkv = [torch.from_numpy(x).to(device=device, dtype=getattr(torch, dtype))
           for x in qkv]
    if q_pos == "tail":
        q_pos = list(range(s - t, s))
    if q_pos is None:
        q_pos = list(range(t))
    pos = torch.tensor(q_pos, dtype=torch.int32, device=device)
    return qkv, dict(q_pos=pos, causal=causal, window=window)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_kernel_matches_plain_version(cuda, name, dtype):
    """The kernel the wrapper picks (csrc/flash_attention_fp32tc.cu for
    fp32, flash_attention_prefill.cu or flash_attention_decode.cu for bf16)
    vs kernels.ref.reference_attention."""
    qkv, kw = _inputs(name, dtype, cuda)
    b, t, s, h, kvh, d = CASES[name][:6]
    path = fa.plan(b, t, s, h, kvh, d, getattr(torch, dtype)).path
    assert path == ("fp32_tc" if dtype == "float32" else
                    "decode" if t <= 16 else "prefill")
    before = fa.launches, fa.launches_by_path[path]
    got = fa.flash_attention(*qkv, **kw)
    torch.cuda.synchronize()
    assert (fa.launches, fa.launches_by_path[path]) == (before[0] + 1,
                                                        before[1] + 1)
    want = reference_attention(*qkv, **kw)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), **TOL[dtype])
    if name in ALL_MASKED:
        assert not got.any()


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take(cuda):
    qkv, kw = _inputs("gqa2_d32", "float32", cuda)
    q, k, v = qkv
    with pytest.raises(TypeError):
        fa.flash_attention(q.half(), k.half(), v.half(), **kw)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2),
                           k, v, **kw)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention(q[..., :24].contiguous(), k[..., :24].contiguous(),
                           v[..., :24].contiguous(), **kw)


@pytest.mark.cuda
def test_kernel_wrappers_refuse_grad_on_the_card(cuda):
    """A kernel's output is a tensor autograd cannot see: under grad the
    wrappers raise; the Function is the way in."""
    qkv, kw = _inputs("gqa2_d32", "bfloat16", cuda)
    q = qkv[0].clone().requires_grad_(True)
    with pytest.raises(RuntimeError, match="autograd"):
        fa.flash_attention(q, *qkv[1:], **kw)
    from repro_torch.models import flash as MF
    o = MF.flash_attention(q, *qkv[1:], q_pos=kw["q_pos"],
                           kv_pos=torch.arange(qkv[1].shape[1],
                                               dtype=torch.int32,
                                               device=cuda),
                           causal=kw["causal"], window=kw["window"])
    assert o.grad_fn is not None
    x = torch.zeros((1, 16, 1, 16), device=cuda, requires_grad=True)
    gate = torch.zeros((1, 16, 1), device=cuda)
    with pytest.raises(RuntimeError, match="autograd"):
        ms.mlstm_scan(x, x, x, gate, gate, chunk=16)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["gqa3_d128_odd", "window7", "noncausal",
                                  "some_rows_masked", "fully_masked_rows",
                                  "decode_t16", "decode_t2_d64", "decode_g1",
                                  "mqa_d256_window_tail", "gqa3_d256_odd",
                                  "decode_t16_d256", "wide_range_d64",
                                  "wide_range_d256", "gqa5_d256_odd_t",
                                  "gqa5_d16_window", "cache_past_fill"]
                         + TRAIN_LSE_CASES)
def test_function_and_lse_match_plain_version(cuda, name, dtype):
    """The Function's forward on the card (the fp32 tensor-core kernel, or
    the prefill kernel in bf16 whatever T is) and its lse against the plain
    version; dq, dk, dv against the plain version's autograd: lse atol 2e-5
    (fp32) and 1e-3 (bf16), gradients relative L2 1e-4 and 2e-2."""
    from repro_torch.models import flash as MF
    qkv, kw = _inputs(name, dtype, cuda)
    s = qkv[1].shape[1]
    kw = dict(kw, kv_pos=torch.arange(s, dtype=torch.int32, device=cuda))
    before = dict(fa.launches_by_path)
    with torch.no_grad():
        o, lse = fa.flash_attention(*qkv, **kw, return_lse=True)
    path = "fp32_tc" if dtype == "float32" else "prefill"
    assert fa.launches_by_path[path] == before[path] + 1
    assert fa.launches_by_path["decode"] == before["decode"]
    o_ref, lse_ref = reference_attention(*qkv, **kw, return_lse=True)
    np.testing.assert_allclose(o.float().cpu().numpy(),
                               o_ref.float().cpu().numpy(), **TOL[dtype])
    assert torch.equal(lse >= 1e29, lse_ref >= 1e29)
    np.testing.assert_allclose(lse.cpu().numpy(), lse_ref.cpu().numpy(),
                               rtol=0, atol=2e-5 if dtype == "float32"
                               else 1e-3)
    do = torch.randn(qkv[0].shape, generator=torch.Generator(
        device=cuda).manual_seed(0), device=cuda).to(qkv[0].dtype)
    grads = []
    for fn in (MF.flash_attention, reference_attention):
        leaves = [x.detach().clone().requires_grad_(True) for x in qkv]
        fn(*leaves, **kw).backward(do)
        grads.append([x.grad.float() for x in leaves])
    tol = 1e-4 if dtype == "float32" else 2e-2
    for a, b in zip(*grads):
        assert float((a - b).norm()) <= tol * max(float(b.norm()), 1e-30)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["llama3.2-3b", "granite-moe-3b-a800m",
                                  "gemma3-1b", "starcoder2-3b", "hymba-1.5b",
                                  "whisper-base", "internvl2-26b"])
def test_training_on_the_card_matches_the_cpu(cuda, arch):
    """loss_and_grads of the reduced model in fp32, card (the fp32
    tensor-core kernel through the Function) against CPU: loss rtol 1e-5,
    every gradient leaf relative L2 1e-4.  hymba-1.5b (its SSM under grad,
    4 meta tokens), whisper-base (16 seeded frames: encoder and
    cross-attention) and internvl2-26b (8 seeded patch embeddings) too."""
    from repro_torch.optim.adamw import tree_leaves, tree_map
    from repro_torch.runtime.trainer import loss_and_grads
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32",
                              remat="full")
    params = init_params(0, cfg, device="cpu")
    rng = np.random.default_rng(2)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 40)))
             for k in ("tokens", "labels")}
    for name, on, length in (("frames", cfg.is_encdec, cfg.encoder_seq_len),
                             ("patch_embeds", cfg.num_patch_tokens,
                              cfg.num_patch_tokens)):
        if on:
            batch[name] = torch.from_numpy((rng.normal(
                size=(2, length, cfg.d_model)) * 0.02).astype(np.float32))
    before = fa.launches_by_path["fp32_tc"]
    loss_c, _, g_c = loss_and_grads(
        tree_map(lambda _, a: a.to(cuda), params),
        {k: v.to(cuda) for k, v in batch.items()}, cfg)
    # remat "full": every attention runs again in the backward
    calls = (cfg.num_layers + cfg.block_pattern.count("attn_cross")
             + (cfg.encoder_layers if cfg.is_encdec else 0))
    assert fa.launches_by_path["fp32_tc"] - before == 2 * calls
    loss, _, g = loss_and_grads(params, batch, cfg)
    np.testing.assert_allclose(float(loss_c), float(loss), rtol=1e-5)
    for a, b in zip(tree_leaves(g_c), tree_leaves(g)):
        a = a.cpu()
        assert float((a - b).norm()) <= 1e-4 * max(float(b.norm()), 1e-30)


# Prompt length per model: 256 is a multiple of the mLSTM chunk, so the
# xLSTM's prefill takes the mlstm_scan kernel on the card.
PROMPT = {"llama3.2-3b": 70, "lacin-demo": 70, "xlstm-350m": 256,
          "gemma3-1b": 70, "starcoder2-3b": 70, "hymba-1.5b": 70,
          "whisper-base": 70, "internvl2-26b": 70}


@pytest.mark.cuda
def test_silu_on_the_card_is_f_silu(cuda):
    """layers.silu on a CUDA tensor is F.silu (one kernel), on the CPU the
    op-by-op silu that rounds as the reference does; in fp32 the two agree
    to 1e-6."""
    from repro_torch.models import layers as TL
    x = torch.from_numpy(np.random.default_rng(7).normal(
        size=(4096,)).astype(np.float32) * 3)
    for dtype in (torch.float32, torch.bfloat16):
        xc = x.to(cuda, dtype)
        assert torch.equal(TL.silu(xc), torch.nn.functional.silu(xc))
    np.testing.assert_allclose(TL.silu(x.to(cuda)).cpu().numpy(),
                               TL.silu(x).numpy(), rtol=0, atol=1e-6)


@functools.cache
def _chip_smoke():
    """chip_smoke.py as a module: its model_extras draws the stub frames
    and patch embeddings the model tests feed."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.cuda
@pytest.mark.parametrize("arch,head_dim", [
    ("llama3.2-3b", None), ("lacin-demo", None), ("xlstm-350m", None),
    ("gemma3-1b", None), ("gemma3-1b", 256), ("starcoder2-3b", None),
    ("hymba-1.5b", None), ("whisper-base", None), ("internvl2-26b", None)])
def test_model_on_the_card_matches_the_cpu(cuda, arch, head_dim):
    """prefill + decode_step with the kernels (card) vs with the plain
    versions (CPU), reduced config in float32: atol 1e-4.  gemma3-1b also
    at its published head dim, 256 (the fp32 tensor-core kernel's D = 256 instances).
    whisper-base gets seeded frames, internvl2-26b seeded patch
    embeddings; decode goes on at T + prefix."""
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    if head_dim is not None:
        cfg = dataclasses.replace(cfg, head_dim=head_dim)
    params = init_params(0, cfg, device="cpu")
    on_card = TT.cast_params(params, cfg, cuda)
    t = PROMPT[arch]
    rng = np.random.default_rng(1)
    batch = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (2, t)))}
    batch.update(_chip_smoke().model_extras(cfg, 2, rng, "cpu"))
    pos = t + TT.prefix_len(cfg, batch)
    out = {}
    for dev, p in (("cpu", params), ("cuda", on_card)):
        before = ms.launches
        logits, caches = TT.prefill(
            p, {k: v.to(dev) for k, v in batch.items()}, cfg, pos + 26)
        launched = ms.launches - before
        step, _ = TT.decode_step(p, logits.argmax(-1).to(dev), caches, pos,
                                 cfg, pos + 26)
        out[dev] = [logits.cpu().numpy(), step.cpu().numpy()]
    # one mlstm_scan launch per mLSTM layer of the prefill on the card
    assert launched == cfg.block_pattern.count("mlstm")
    for a, b in zip(out["cuda"], out["cpu"]):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4)


MLSTM_TOL = {"float32": dict(rtol=5e-4, atol=5e-5),
             "bfloat16": dict(rtol=5e-2, atol=5e-2)}

# name: (b, t, h, d, chunk, gates); gates "normal", "forget_near_zero"
# (log_f << 0), "forget_near_one" (log_f ~ 0: C sums every step of T),
# "large_log_i" (the stabilizer dominates) or "state" (a given initial
# state).  Calls whose chunk is a multiple of 16 take the tensor-core kernel
# of their dtype (fp32: in split precision), the others csrc/mlstm_scan.cu
# (chunk24_bf16, in either dtype).
MLSTM_CASES = {
    "d16": (1, 64, 1, 16, 16, "normal"),
    "d32_chunk48": (1, 96, 2, 32, 48, "normal"),
    "d64_four_chunks": (2, 256, 2, 64, 64, "normal"),
    "d128": (1, 256, 2, 128, 128, "normal"),
    "d512_two_chunks": (1, 512, 2, 512, 256, "normal"),
    "forget_near_zero": (1, 256, 2, 64, 64, "forget_near_zero"),
    "large_log_i": (1, 256, 2, 64, 64, "large_log_i"),
    "initial_state": (2, 128, 2, 64, 64, "state"),
    "bh1_d128": (1, 128, 1, 128, 64, "normal"),
    "forget_near_one": (1, 1024, 2, 512, 256, "forget_near_one"),
    "many_chunks_d512": (1, 1024, 1, 512, 64, "normal"),
    "state_d512": (2, 512, 2, 512, 256, "state"),
    "d48": (1, 128, 2, 48, 32, "normal"),
    "chunk16_d64": (1, 64, 2, 64, 16, "normal"),
    "chunk24_bf16": (1, 96, 2, 32, 24, "normal"),
    # D = 512 with forget gates near one and over many chunks, each from a
    # given state
    "forget_near_one_state": (1, 1024, 2, 512, 256, "forget_near_one_state"),
    "many_chunks_d512_state": (1, 1024, 1, 512, 64, "state"),
}
LF_SHIFT = {"forget_near_zero": -20.0, "forget_near_one": 20.0,
            "forget_near_one_state": 20.0}


def _mlstm_inputs(name, dtype, device):
    b, t, h, d, chunk, gates = MLSTM_CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))

    def draw(*shape, scale=1.0, shift=0.0):
        return rng.normal(size=shape).astype(np.float32) * scale + shift
    qkv = [torch.from_numpy(draw(b, t, h, d)).to(device=device,
                                                 dtype=getattr(torch, dtype))
           for _ in range(3)]
    li = draw(b, t, h, scale=2.0, shift=40.0 if gates == "large_log_i" else 0.0)
    lf = draw(b, t, h, scale=2.0, shift=LF_SHIFT.get(gates, 1.0))
    gate_t = [torch.from_numpy(li).to(device),
              torch.nn.functional.logsigmoid(torch.from_numpy(lf)).to(device)]
    state = None
    if gates.endswith("state"):
        state = (torch.from_numpy(draw(b, h, d, d, scale=0.1)).to(device),
                 torch.from_numpy(np.abs(draw(b, h, d))).to(device),
                 torch.from_numpy(draw(b, h)).to(device))
    return qkv + gate_t, state, chunk


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(MLSTM_CASES))
def test_mlstm_kernel_matches_plain_version(cuda, name, dtype):
    """The kernel the wrapper picks (csrc/mlstm_scan_tc.cu for bf16 and
    csrc/mlstm_scan_fp32tc.cu for fp32 where the chunk is a multiple of 16,
    csrc/mlstm_scan.cu for the other calls) vs kernels.ref.
    reference_mlstm_scan (the chunkwise mLSTM): h and the final (C, n, m),
    in bf16 element by element, in fp32 by mlstm_scan.check_fp32 (held to
    the plain version where it meets float64, else to float64 row by row:
    ROADMAP C21)."""
    args, state, chunk = _mlstm_inputs(name, dtype, cuda)
    b, t, h, d = args[0].shape
    path = ms.plan(b, t, h, d, chunk, getattr(torch, dtype),
                   state is not None).path
    assert path == ("fma" if chunk % 16 else
                    "tc" if dtype == "bfloat16" else "tc_f32")
    before = ms.launches, ms.launches_by_path[path]
    got_h, got_state = ms.mlstm_scan(*args, state, chunk=chunk)
    torch.cuda.synchronize()
    assert (ms.launches, ms.launches_by_path[path]) == (before[0] + 1,
                                                        before[1] + 1)
    want_h, want_state = reference_mlstm_scan(*args, state, chunk=chunk)
    assert got_h.dtype == want_h.dtype and got_h.shape == want_h.shape
    if dtype == "float32":
        parts = [dict(zip("hCnm", (x, *xs))) for x, xs in (
            (got_h, got_state), (want_h, want_state),
            reference_mlstm_scan_float64(*args, state, chunk=chunk))]
        readings = ms.check_fp32(*parts, tol=MLSTM_TOL[dtype])
        assert readings["ok"], readings
        return
    # the state is fp32 on both sides; bf16 inputs are the same values
    for got, want, tol in ((got_h, want_h, MLSTM_TOL[dtype]),
                           *zip(got_state, want_state,
                                [MLSTM_TOL["float32"]] * 3)):
        np.testing.assert_allclose(got.float().cpu().numpy(),
                                   want.float().cpu().numpy(), **tol)


@pytest.mark.cuda
def test_mlstm_kernel_refuses_what_it_does_not_take(cuda):
    (q, k, v, li, lf), _, chunk = _mlstm_inputs("d32_chunk48", "float32",
                                                cuda)
    with pytest.raises(TypeError):
        ms.mlstm_scan(q.half(), k.half(), v.half(), li, lf, chunk=chunk)
    with pytest.raises(TypeError, match="float32"):
        ms.mlstm_scan(q, k, v, li.bfloat16(), lf, chunk=chunk)
    with pytest.raises(ValueError, match="multiple"):
        ms.mlstm_scan(q, k, v, li, lf, chunk=64)
    with pytest.raises(ValueError, match="head_dim"):
        ms.mlstm_scan(q[..., :8].contiguous(), k[..., :8].contiguous(),
                      v[..., :8].contiguous(), li, lf, chunk=chunk)
    with pytest.raises(ValueError, match="contiguous"):
        ms.mlstm_scan(q.transpose(1, 2).contiguous().transpose(1, 2), k, v,
                      li, lf, chunk=chunk)


@pytest.mark.cuda
@pytest.mark.parametrize("policy,drain", [("minimal", False),
                                          ("adaptive", True)])
def test_cycle_engine_on_the_card_matches_the_cpu(cuda, policy, drain):
    """repro_torch.sim.sweep through its CUDA graph against the same sweep
    run eagerly on the CPU: every RunStats field but timing and trace."""
    from repro_torch import sim
    from repro_torch.core import DragonflyConfig

    topo = sim.dragonfly_topology(DragonflyConfig(6, 3, 2, 12))
    pol = (sim.AdaptivePolicy(threshold=0.5, weight=1.3)
           if policy == "adaptive" else policy)

    def tf(load, seed):
        return sim.uniform(72, offered=load, cycles=50, terminals=3,
                           seed=seed)
    grids = [sim.sweep(topo, pol, tf, [0.4, 0.9], seeds=(1, 2), terminals=3,
                       cycles=50, warmup=12, drain=drain, device=dev)
             for dev in (cuda, "cpu")]
    for got, want in zip(*(sum(g, []) for g in grids)):
        for f in dataclasses.fields(got):
            if f.name in ("timing", "trace"):
                continue
            assert np.array_equal(np.asarray(getattr(got, f.name)),
                                  np.asarray(getattr(want, f.name))), f.name
    assert grids[0][0][0].timing["compile_s"] > 0      # a graph was captured


def _cache_sweep(cuda, loads, seeds, cycles=50, policy="minimal"):
    """One sweep of a small Dragonfly on the card and on the CPU."""
    from repro_torch import sim
    from repro_torch.core import DragonflyConfig

    topo = sim.dragonfly_topology(DragonflyConfig(4, 2, 2, 9))

    def tf(load, seed):
        return sim.uniform(36, offered=load, cycles=cycles, terminals=2,
                           seed=seed)
    return [sim.sweep(topo, policy, tf, loads, seeds=seeds, terminals=2,
                      cycles=cycles, warmup=10, device=dev)
            for dev in (cuda, "cpu")]


def _same_grids(got, want):
    for a, b in zip(sum(got, []), sum(want, [])):
        for f in dataclasses.fields(a):
            if f.name in ("timing", "trace"):
                continue
            assert np.array_equal(np.asarray(getattr(a, f.name)),
                                  np.asarray(getattr(b, f.name))), f.name


@pytest.mark.cuda
def test_graph_cache_hit_replays_the_kept_graph(cuda):
    """A second sweep of one key (other loads and seeds) replays the kept
    graph: compile_cached "memory", compile_s 0.0, and the CPU's result."""
    from repro_torch.obs import telemetry
    telemetry.clear_caches()
    telemetry.reset_cache_stats()
    first = _cache_sweep(cuda, [0.3, 0.8], (1, 2))
    second = _cache_sweep(cuda, [0.4, 0.7], (3, 4))
    assert first[0][0][0].timing["compile_cached"] is False
    assert second[0][0][0].timing["compile_cached"] == "memory"
    assert second[0][0][0].timing["compile_s"] == 0.0
    assert telemetry.cache_stats()["memory_hits"] == 1
    _same_grids(*first)
    _same_grids(*second)


@pytest.mark.cuda
@pytest.mark.parametrize("policy", ["valiant", "adaptive"])
def test_graph_cache_refill_leaves_nothing_stale(cuda, policy):
    """Drained and traced replays through a kept graph: after a run that
    filled the state, the ejection record, phase record and trace rings,
    a hit of the same key equals the CPU bit for bit."""
    from repro_torch.fabric import make_fabric
    from repro_torch.obs import telemetry
    telemetry.clear_caches()
    fab = make_fabric("xor", 8)
    runs = {}
    for seed in (0, 5):
        for dev in (cuda, "cpu"):
            runs[seed, str(dev)] = fab.replay(
                "all_to_all", message_size=2, policy=policy, seed=seed,
                trace=True, device=dev)
    hit = runs[5, "cuda"]
    assert hit.timing["compile_cached"] == "memory"
    _same_grids([[hit]], [[runs[5, "cpu"]]])
    assert hit.trace.equals(runs[5, "cpu"].trace)
    first = _cache_sweep(cuda, [0.5], (1,), policy=policy)
    again = _cache_sweep(cuda, [0.55], (2,), policy=policy)  # one bucket
    assert again[0][0][0].timing["compile_cached"] == "memory"
    _same_grids(*first)
    _same_grids(*again)


@pytest.mark.cuda
def test_graph_cache_evicts_past_its_limit(cuda, monkeypatch):
    from repro_torch.obs import telemetry
    telemetry.clear_caches()
    telemetry.reset_cache_stats()
    monkeypatch.setattr(telemetry, "_CACHE_LIMIT", 2)
    for cycles in (20, 40, 60, 20):         # horizons 24, 40, 64, 24
        got, want = _cache_sweep(cuda, [0.5], (1,), cycles=cycles)
        _same_grids(got, want)
    assert got[0][0].timing["compile_cached"] is False
    assert telemetry.cache_stats()["evictions"] == 2
    assert len(telemetry._CACHE) == 2
    telemetry.clear_caches()


# The scan under autograd (repro_torch.models.xlstm.MLSTMScan): name: (b, t,
# h, d, chunk, gates); "input_x30" scales log_i by 30, "forget_minus40"
# shifts the forget pre-activation by -40, "first_gate_minus100" opens every
# sequence with log_i = -100 (exp(-m) beyond float32).
MLSTM_GRAD_CASES = {
    "one_chunk_d64": (2, 64, 2, 64, 64, "normal"),
    "four_chunks_d64": (2, 256, 2, 64, 64, "normal"),
    "d512_two_chunks": (1, 512, 2, 512, 256, "normal"),
    "input_x30": (2, 256, 2, 64, 64, "input_x30"),
    "forget_minus40": (2, 256, 2, 64, 64, "forget_minus40"),
    "first_gate_minus100": (2, 128, 2, 64, 64, "first_gate_minus100"),
    "bh1": (1, 256, 1, 128, 64, "normal"),
}


def _mlstm_grad_inputs(name, dtype, device):
    b, t, h, d, chunk, gates = MLSTM_GRAD_CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))

    def draw(*shape):
        return rng.normal(size=shape).astype(np.float32)
    qkv = [torch.from_numpy(draw(b, t, h, d)).to(device=device,
                                                 dtype=getattr(torch, dtype))
           for _ in range(4)]
    li, pre_f = draw(b, t, h) * 2, draw(b, t, h) * 2 + 1
    if gates == "input_x30":
        li = li * 30
    if gates == "forget_minus40":
        pre_f = pre_f - 40
    if gates == "first_gate_minus100":
        li[:, 0] = -100.0
    gate_t = [torch.from_numpy(li).to(device),
              torch.nn.functional.logsigmoid(torch.from_numpy(pre_f)).to(
                  device)]
    return qkv[:3] + gate_t, qkv[3], chunk


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(MLSTM_GRAD_CASES))
def test_mlstm_function_matches_plain_autograd(cuda, name, dtype):
    """MLSTMScan on the card (the kernel forward, the plain chunkwise
    backward) against autograd through the plain version: h at
    MLSTM_TOL[dtype] (in fp32 h and the final state by
    mlstm_scan.check_fp32, ROADMAP C21), dq, dk, dv, dlog_i, dlog_f at
    MLSTM_TOL[dtype] and finite; one scan launch and one backward call."""
    from repro_torch.models import xlstm as TX
    args, dh, chunk = _mlstm_grad_inputs(name, dtype, cuda)
    outs, finals = {}, {}
    for how in ("function", "plain"):
        leaves = [x.detach().clone().requires_grad_(True) for x in args]
        before = ms.launches, TX.backward_calls
        if how == "function":
            h, final = TX.mlstm_scan_grad(*leaves, chunk=chunk)
        else:
            h, final = reference_mlstm_scan(*leaves, chunk=chunk)
        grads = torch.autograd.grad(h, leaves, dh)
        launched = ms.launches - before[0], TX.backward_calls - before[1]
        assert launched == ((1, 1) if how == "function" else (0, 0))
        outs[how] = [h.detach()] + list(grads)
        finals[how] = dict(zip("hCnm", (h.detach(),
                                        *(x.detach() for x in final))))
    if dtype == "float32":
        exact = reference_mlstm_scan_float64(*args, chunk=chunk)
        readings = ms.check_fp32(finals["function"], finals["plain"],
                                 dict(zip("hCnm", (exact[0], *exact[1]))),
                                 tol=MLSTM_TOL[dtype])
        assert readings["ok"], readings
        outs = {how: o[1:] for how, o in outs.items()}
    for got, want in zip(outs["function"], outs["plain"]):
        assert got.dtype == want.dtype and torch.isfinite(got).all()
        np.testing.assert_allclose(got.float().cpu().numpy(),
                                   want.float().cpu().numpy(),
                                   **MLSTM_TOL[dtype])


@pytest.mark.cuda
def test_xlstm_training_on_the_card_matches_the_cpu(cuda):
    """loss_and_grads of the reduced xlstm-350m in fp32 at T = 256 under
    remat "full", card (the split scan kernel through MLSTMScan) against CPU:
    loss rtol 1e-5, every gradient leaf relative L2 1e-4; two scan launches
    (forward and recompute) and one backward call an mLSTM layer."""
    from repro_torch.models import xlstm as TX
    from repro_torch.optim.adamw import tree_leaves, tree_map
    from repro_torch.runtime.trainer import loss_and_grads
    cfg = dataclasses.replace(get_config("xlstm-350m").reduced(),
                              dtype="float32", remat="full")
    params = init_params(0, cfg, device="cpu")
    rng = np.random.default_rng(3)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 256)))
             for k in ("tokens", "labels")}
    before = ms.launches_by_path["tc_f32"], TX.backward_calls
    loss_c, _, g_c = loss_and_grads(
        tree_map(lambda _, a: a.to(cuda), params),
        {k: v.to(cuda) for k, v in batch.items()}, cfg)
    mlstm = cfg.block_pattern.count("mlstm")
    assert (ms.launches_by_path["tc_f32"] - before[0],
            TX.backward_calls - before[1]) == (2 * mlstm, mlstm)
    loss, _, g = loss_and_grads(params, batch, cfg)
    np.testing.assert_allclose(float(loss_c), float(loss), rtol=1e-5)
    for a, b in zip(tree_leaves(g_c), tree_leaves(g)):
        a = a.cpu()
        assert torch.isfinite(a).all()
        assert float((a - b).norm()) <= 1e-4 * max(float(b.norm()), 1e-30)
