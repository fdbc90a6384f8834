"""The port on the card: the CUDA flash-attention kernel against its plain
version, and the model on the card against the model on the CPU.

Every test here is marked ``cuda`` and skips where there is no GPU.  This
file imports neither jax nor repro, so it runs where only the port is
installed:  PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
Tolerances: float32 2e-5 and bfloat16 2e-2, as in tests/test_kernels.py.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels.ref import reference_attention
from repro_torch.models import get_config, init_params
from repro_torch.models import transformer as TT

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
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(name, dtype, device):
    b, t, s, h, kvh, d, q_pos, causal, window = CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    qkv = [torch.from_numpy(rng.normal(size=shape).astype(np.float32))
           .to(device=device, dtype=getattr(torch, dtype))
           for shape in ((b, t, h, d), (b, s, kvh, d), (b, s, kvh, d))]
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
    """csrc/flash_attention.cu vs kernels.ref.reference_attention."""
    qkv, kw = _inputs(name, dtype, cuda)
    before = fa.launches
    got = fa.flash_attention(*qkv, **kw)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    want = reference_attention(*qkv, **kw)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), **TOL[dtype])
    if name == "fully_masked_rows":
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
@pytest.mark.parametrize("arch", ["llama3.2-3b", "lacin-demo"])
def test_model_on_the_card_matches_the_cpu(cuda, arch):
    """prefill + decode_step with the kernel (card) vs with the plain
    version (CPU), reduced config in float32: atol 1e-4."""
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    params = init_params(0, cfg, device="cpu")
    on_card = TT.cast_params(params, cfg, cuda)
    tokens = torch.from_numpy(
        np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 70)))
    out = {}
    for dev, p in (("cpu", params), ("cuda", on_card)):
        logits, caches = TT.prefill(p, {"tokens": tokens.to(dev)}, cfg, 96)
        step, _ = TT.decode_step(p, logits.argmax(-1).to(dev), caches, 70,
                                 cfg, 96)
        out[dev] = [logits.cpu().numpy(), step.cpu().numpy()]
    for a, b in zip(out["cuda"], out["cpu"]):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4)
