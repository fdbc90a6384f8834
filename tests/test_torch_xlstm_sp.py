"""repro_torch.models.xlstm_sp (the context-parallel mLSTM) on a gloo group
of 8 ranks, against the JAX reference's sequential mLSTM, on the CPU.

As tests/test_xlstm_sp.py sets it: b 2, t 512 (64 positions a rank), h 2,
d 32, chunk 32; here the inputs are drawn from one numpy seed, log_i ~
N(0, 2) and log_f = log_sigmoid(N(1, 2)).  Each rank is a process of its
own (the harness of tests/test_torch_collectives.py).  Tolerances: h
within 1e-4 of the sequential oracle's largest |h| (tests/test_xlstm_sp.py's
bound); the gradient of sum(h^2) in q, through the distributed scan's
shifts, finite and within 1e-4 of its largest entry of the single-process
chunkwise scan's (repro_torch.models.xlstm.mlstm_chunkwise); and
mlstm_chunkwise_raw against the reference's: its log-domain outputs (m_loc,
b_global, F, m) within 1e-6 of the largest |b_global|, the cumulative
log-forget whose fp32 rounding they inherit (torch's cumsum and XLA's add
in other orders: 1.5e-5 at |b_global| 90), and its linear outputs (num,
dot, C, n) within 1e-5 of their largest entry, the relative error that
rounding of their exponents makes (2.7e-6 seen).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import xlstm as JX

from repro_torch.models import xlstm as TX

from test_torch_collectives import join_ranks, start_ranks

WORLD, B, T, H, D, CHUNK = 8, 2, 512, 2, 32, 32
#: Leaves of mlstm_chunkwise_raw's output, in tree order (num, dot, m_loc,
#: b_global, F, C, n, m), that are exponents.
LOG_DOMAIN = (2, 3, 4, 7)

_INPUTS = r"""
import numpy as np

def make_inputs(b, t, h, d):
    rng = np.random.default_rng(11)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    q, k, v = f(b, t, h, d), f(b, t, h, d), f(b, t, h, d)
    li = f(b, t, h) * 2
    pre = f(b, t, h) * 2 + 1
    lf = (-np.logaddexp(0, -pre)).astype(np.float32)      # log_sigmoid
    return q, k, v, li, lf
"""

_RANK = _INPUTS + r"""
import datetime, sys
import torch, torch.distributed as dist
torch.set_num_threads(1)
rank, world, store, outdir = (int(sys.argv[1]), int(sys.argv[2]),
                              sys.argv[3], sys.argv[4])
dist.init_process_group("gloo", store=dist.FileStore(store, world),
                        rank=rank, world_size=world,
                        timeout=datetime.timedelta(seconds=120))
from repro_torch.models.xlstm_sp import mlstm_context_parallel
b, t, h, d, chunk = %d, %d, %d, %d, %d
n = t // world
seg = [torch.from_numpy(x[:, rank * n:(rank + 1) * n].copy())
       for x in make_inputs(b, t, h, d)]
q = seg[0].requires_grad_(True)
out = mlstm_context_parallel(q, *seg[1:], group=dist.group.WORLD,
                             chunk=chunk)
(out ** 2).sum().backward()
dist.barrier()
dist.destroy_process_group()
np.savez(f"{outdir}/out_{rank}.npz", h=out.detach().numpy(),
         dq=q.grad.numpy())
""" % (B, T, H, D, CHUNK)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs():
    scope = {}
    exec(_INPUTS, scope)
    return scope["make_inputs"](B, T, H, D)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    outs = join_ranks(start_ranks(_RANK, WORLD,
                                  tmp_path_factory.mktemp("xlstm_sp")))
    return (np.concatenate([o["h"] for o in outs], axis=1),
            np.concatenate([o["dq"] for o in outs], axis=1))


def test_context_parallel_mlstm_matches_sequential(ranks):
    h, _ = ranks
    ref, _ = jax.jit(JX.mlstm_sequential)(*map(jnp.asarray, _inputs()))
    ref = np.asarray(ref)
    assert h.shape == ref.shape == (B, T, H, D)
    rel = np.abs(h - ref).max() / np.abs(ref).max()
    assert rel < 1e-4, rel


def test_context_parallel_gradients_match_single_process(ranks):
    _, dq = ranks
    q, k, v, li, lf = map(torch.from_numpy, _inputs())
    q = q.clone().requires_grad_(True)
    h, _ = TX.mlstm_chunkwise(q, k, v, li, lf, chunk=CHUNK)
    (h ** 2).sum().backward()
    want = q.grad.numpy()
    assert np.isfinite(dq).all()
    err = np.abs(dq - want).max() / np.abs(want).max()
    assert err < 1e-4, err


@pytest.mark.parametrize("chunk", [32, 64])
def test_chunkwise_raw_matches_reference(chunk):
    """The raw chunkwise pass over one segment of 128 positions."""
    args = [x[:, :128] for x in _inputs()]
    want = jax.tree_util.tree_leaves(jax.jit(
        JX.mlstm_chunkwise_raw, static_argnames="chunk")(
        *map(jnp.asarray, args), chunk=chunk))
    got = jax.tree_util.tree_leaves(TX.mlstm_chunkwise_raw(
        *map(torch.from_numpy, args), chunk=chunk), is_leaf=torch.is_tensor)
    assert len(got) == len(want) == 8
    log_scale = np.abs(np.asarray(want[3])).max()
    for i, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w)
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
        atol = (1e-6 * log_scale if i in LOG_DOMAIN
                else 1e-5 * np.abs(w).max())
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=atol)
    # the local h it describes is the chunkwise scan's
    num, dot, m_loc = got[:3]
    h, _ = TX.mlstm_chunkwise(*map(torch.from_numpy, args), chunk=chunk)
    np.testing.assert_allclose(
        (num / TX._denominator(dot, m_loc)[..., None]).numpy(), h.numpy(),
        rtol=0, atol=1e-6 * float(h.abs().max()))
