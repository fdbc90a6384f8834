"""repro_torch.launch.specs against the JAX reference repro.launch.specs, on
the CPU: for every registered architecture and every assigned shape, each
input's shape and dtype, leaf for leaf.  The port's decode caches are one
dict per layer; the reference stacks each run's layers along a leading
axis, so the port's are stacked run by run before they are compared."""
import numpy as np
import pytest
import torch

from repro.launch import specs as JS
from repro.models import get_config as jax_get_config
from repro.models import list_archs
from repro.models.config import SHAPES as JSHAPES

from repro_torch.launch import specs as TS
from repro_torch.models import get_config
from repro_torch.models.config import SHAPES
from repro_torch.models.transformer import build_runs


def _signature(x):
    return tuple(x.shape), np.dtype(str(x.dtype).removeprefix("torch."))


def _stacked(caches, cfg):
    """The port's per-layer caches as the reference's per-run stack of
    (count, ...) leaves."""
    out, i = [], 0
    for run in build_runs(cfg):
        group = caches[i:i + run.count]
        out.append({k: ((run.count,) + tuple(group[0][k].shape),
                        np.dtype(str(group[0][k].dtype).removeprefix(
                            "torch.")))
                    for k in group[0]})
        assert all({k: _signature(v) for k, v in c.items()}
                   == {k: _signature(v) for k, v in group[0].items()}
                   for c in group)
        i += run.count
    assert i == len(caches)
    return out


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("arch", list_archs())
def test_input_specs_match_reference(arch, shape):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    got = TS.input_specs(cfg, SHAPES[shape])
    want = JS.input_specs(jcfg, JSHAPES[shape])
    assert list(got) == list(want)
    for name, w in want.items():
        g = got[name]
        if name == "caches":
            assert _stacked(g, cfg) == [
                {k: (v.shape, np.dtype(v.dtype)) for k, v in run.items()}
                for run in w]
            assert all(x.device.type == "meta" for c in g for x in c.values())
        elif w is None:
            assert g is None
        else:
            assert isinstance(g, torch.Tensor) and g.device.type == "meta"
            assert _signature(g) == (w.shape, np.dtype(w.dtype)), name


def test_training_text_leaves_room_for_the_prefix():
    """hymba-1.5b's meta tokens, internvl2-26b's patches and whisper-base's
    frames: the text is what the sequence leaves of them."""
    shape = SHAPES["train_4k"]
    hymba = TS.train_input_specs(get_config("hymba-1.5b"), shape)
    assert hymba["tokens"].shape[1] == 4096 - 128
    vlm = TS.train_input_specs(get_config("internvl2-26b"), shape)
    assert vlm["tokens"].shape[1] == 4096 - 256
    assert vlm["patch_embeds"].shape == (256, 256, 6144)
    enc = TS.train_input_specs(get_config("whisper-base"), shape)
    assert enc["frames"].shape == (256, 1500, 512)
    assert "labels" not in TS.prefill_input_specs(get_config("whisper-base"),
                                                  shape)
    with pytest.raises(ValueError):
        TS.input_specs(get_config("whisper-base"),
                       SHAPES["train_4k"].__class__("x", 8, 1, "other"))
