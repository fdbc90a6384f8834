"""The plain references against the port at tiny dense and MoE configs on
the CPU, both in float32: the loss, every leaf's gradient and one AdamW
step; and the weights' layout against the port's."""
import dataclasses

import pytest
import torch

from portbench import harness, weights
from portbench.conftest import TINY_CONFIGS, TINY_MIX
from portbench.reference import dense
from portbench.traffic import train as TR


def _setup(name, seed=3):
    config = TINY_CONFIGS[name]
    sizes = harness.model_sizes(config, TINY_MIX["seq"])
    cfg = dataclasses.replace(harness.port_config(config), dtype="float32")
    batch = TR.make_batch(TINY_MIX, sizes["vocab_size"], seed, 0)
    return config, sizes, cfg, batch


@pytest.mark.parametrize("name", sorted(TINY_CONFIGS))
def test_layout_is_the_ports(name):
    config, sizes, cfg, _ = _setup(name)
    TR.check_layout(weights.make(sizes, 0, "cpu"), cfg)
    from repro_torch.models.transformer import param_shapes
    assert weights.n_params(sizes) == sum(
        t.numel() for _, t in weights.leaves(param_shapes(cfg)))


def test_weights_repeat_from_the_seed_and_differ_across_seeds():
    sizes = harness.model_sizes(TINY_CONFIGS["tiny-moe"])
    a, b = weights.make(sizes, 5, "cpu"), weights.make(sizes, 5, "cpu")
    c = weights.make(sizes, 2**31 + 5, "cpu")
    for (pa, ta), (_, tb), (_, tc) in zip(weights.leaves(a),
                                          weights.leaves(b),
                                          weights.leaves(c)):
        assert torch.equal(ta, tb), pa
        assert not torch.equal(ta, tc), pa
    assert all(v == 0 for v in weights.change_norms(sizes, 5, a).values())


@pytest.mark.parametrize("name", sorted(TINY_CONFIGS))
def test_reference_loss_and_gradients_match_the_port(name, one_thread):
    from repro_torch.runtime.trainer import loss_and_grads
    config, sizes, cfg, batch = _setup(name)
    params = weights.make(sizes, 3, "cpu")
    loss, _, grads = loss_and_grads(params, {
        k: torch.as_tensor(v) for k, v in batch.items()}, cfg)
    named = weights.leaves(params)
    for _, p in named:
        p.requires_grad_(True)
    layer = (harness.load_module("reference", "moe").moe_layer
             if sizes["num_experts"] else dense.dense_layer)
    want, _ = dense.loss(params, batch, sizes, dense.Ops(), layer)
    want_grads = torch.autograd.grad(want, [p for _, p in named])
    torch.testing.assert_close(loss, want.detach(), rtol=1e-5, atol=0)
    for (path, _), g, w in zip(named, weights.leaves(grads), want_grads):
        scale = w.norm().clamp_min(1e-12)
        assert ((g[1] - w).norm() / scale) < 1e-4, path


@pytest.mark.parametrize("name", sorted(TINY_CONFIGS))
def test_reference_steps_match_the_ports(name, one_thread):
    """Three AdamW steps of the port in float32 against the reference's:
    losses, the first gradient's norms and the change a leaf."""
    from portbench import check
    config, sizes, cfg, _ = _setup(name)
    first = [TR.make_batch(TINY_MIX, sizes["vocab_size"], 11, i)
             for i in range(3)]
    cell = harness.Cell("t", {}, dict(config, port=dict(
        config["port"], dtype="float32")), TINY_MIX)
    prog = TR.run_program(cell, sizes, 11, torch.device("cpu"), first)
    want = TR.reference_readings(cell, sizes, 11, torch.device("cpu"), first)
    numbers = check.gaps(prog.readings, want)
    assert numbers["loss_gap"] < 1e-5
    assert numbers["grad_norm_gap"] < 1e-4
    # AdamW divides by sqrt(v): an entry whose gradient is near zero moves
    # by a ratio of roundings on both sides
    assert numbers["update_gap"] < 1e-2


#: The control's test sizes and limits, set as the cells' are (PERF.md):
#: from the program's and the control's readings on the CPU at these
#: sizes.  tiny-dense at B8 T128: the program's worst readings over six
#: seeds loss 6.3e-5, gradient norms 4.8e-3; the control's least 1.7e-4
#: and 2.0e-2.  tiny-moe at B16 T256 (4,096 tokens: fewer make the
#: router's flips the larger noise): the program's update 1.8e-3, the
#: control's least 5.6e-3.
CONTROL_CASES = {
    "tiny-dense": ((8, 128), {"loss_gap": 1.2e-4, "grad_norm_gap": 1e-2,
                              "update_gap": 0.1}),
    "tiny-moe": ((16, 256), {"loss_gap": 3e-4, "grad_norm_gap": 4.5e-2,
                             "update_gap": 3.5e-3}),
}


@pytest.mark.parametrize("name", sorted(CONTROL_CASES))
def test_fp8_control_comes_out_not_correct(name, one_thread):
    """The control, the reference with every product's operands in fp8 in
    the program's place, fails the output check where the bf16 program
    passes it, on three seeds."""
    from portbench import check
    (batch, seq), limits = CONTROL_CASES[name]
    mix = dict(TINY_MIX, batch=batch, seq=seq)
    config = TINY_CONFIGS[name]
    sizes = harness.model_sizes(config, seq)
    cell = harness.Cell("t", {}, config, mix)
    device = torch.device("cpu")
    for seed in (1, 2, 3):
        first = [TR.make_batch(mix, sizes["vocab_size"], seed, i)
                 for i in range(3)]
        want = TR.reference_readings(cell, sizes, seed, device, first)
        got = TR.run_program(cell, sizes, seed, device, first).readings
        ctrl = TR.reference_readings(cell, sizes, seed, device, first,
                                     precision="fp8")
        assert check.judge(check.gaps(got, want), limits)[0], seed
        assert not check.judge(check.gaps(ctrl, want), limits)[0], seed
