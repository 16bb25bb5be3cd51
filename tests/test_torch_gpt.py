"""paddle_tpu_torch GPT: logits against the reference package on shared
weights (f32, atol = rtol = 1e-4), the weight bridge, the device
contract, and the package's independence from JAX and the reference.
"""
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import paddle_tpu as P
from paddle_tpu.models.gpt import GPTForCausalLM as RefGPT
from paddle_tpu.models.gpt import gpt3_tiny as ref_tiny

from paddle_tpu_torch.core import device as device_mod
from paddle_tpu_torch.framework.io import (load_numpy_state_dict,
                                           numpy_state_dict)
from paddle_tpu_torch.models.gpt import GPTForCausalLM, gpt3_tiny

REPO = Path(__file__).resolve().parents[1]


def _shared_weights(model, seed):
    """The reference model's state, perturbed so that biases and LN
    affines are not at their trivial init, as numpy arrays."""
    rng = np.random.default_rng(seed)
    sd = {k: np.asarray(t._value) for k, t in model.state_dict().items()}
    return {k: (v + 0.05 * rng.standard_normal(v.shape)).astype(np.float32)
            for k, v in sd.items()}


@pytest.fixture(scope="module", params=[True, False], ids=["fused_ln",
                                                           "plain_ln"])
def model_pair(request):
    P.seed(0)
    ref = RefGPT(ref_tiny(fused_ln=request.param))
    ref.eval()
    sd = _shared_weights(ref, seed=1)
    ref.set_state_dict(sd)
    port = GPTForCausalLM(gpt3_tiny(fused_ln=request.param), device="cpu")
    port.eval()
    load_numpy_state_dict(port, sd)
    return ref, port, sd


@pytest.mark.parametrize("shape", [(2, 16), (1, 37)])
def test_logits_match_reference(model_pair, shape):
    ref, port, _ = model_pair
    ids = np.random.default_rng(2).integers(0, 256, shape)
    want = np.asarray(ref(P.to_tensor(ids))._value)
    with torch.no_grad():
        got = port(torch.tensor(ids)).numpy()
    assert got.shape == want.shape == shape + (256,)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_state_dict_keys_and_round_trip(model_pair):
    _ref, port, sd = model_pair
    out = numpy_state_dict(port)
    assert list(out) == list(sd)
    for k in sd:
        np.testing.assert_array_equal(out[k], sd[k])
    assert out["gpt.layers.0.attn.qkv_proj.weight"].shape == (64, 192)


@pytest.mark.parametrize("fault", ["missing", "extra", "shape"])
def test_load_rejects_bad_state(model_pair, fault):
    _ref, port, sd = model_pair
    bad = dict(sd)
    if fault == "missing":
        bad.pop("gpt.final_ln.bias")
        err = KeyError
    elif fault == "extra":
        bad["gpt.lm_head_weight"] = np.zeros((64, 256), np.float32)
        err = KeyError
    else:
        bad["gpt.final_ln.bias"] = np.zeros(65, np.float32)
        err = ValueError
    before = port.gpt.final_ln.bias.detach().clone()
    with pytest.raises(err):
        load_numpy_state_dict(port, bad)
    assert torch.equal(port.gpt.final_ln.bias, before)   # nothing copied


def test_init_is_seeded_normal():
    cfg = gpt3_tiny(initializer_range=0.5)
    a = GPTForCausalLM(cfg, device="cpu",
                       generator=torch.Generator().manual_seed(3))
    b = GPTForCausalLM(cfg, device="cpu",
                       generator=torch.Generator().manual_seed(3))
    for (k, ta), tb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(ta, tb), k
    w = a.gpt.layers[0].mlp.fc1.weight
    assert abs(w.std().item() - 0.5) < 0.05
    assert torch.all(a.gpt.layers[0].ln1.weight == 1)
    assert torch.all(a.gpt.layers[0].mlp.fc1.bias == 0)


def test_unported_configs_raise():
    """The untied head is ported: its weight crosses by the reference's
    name and its logits are the reference's (f32, atol = rtol = 1e-4).
    (MoE blocks are ported too: ``tests/test_torch_moe.py``.)"""
    P.seed(0)
    ref = RefGPT(ref_tiny(tie_word_embeddings=False))
    ref.eval()
    sd = _shared_weights(ref, seed=3)
    ref.set_state_dict(sd)
    port = GPTForCausalLM(gpt3_tiny(tie_word_embeddings=False), device="cpu")
    port.eval()
    load_numpy_state_dict(port, sd)
    assert list(numpy_state_dict(port)) == list(sd)
    assert tuple(port.lm_head_weight.shape) == (64, 256)
    ids = np.random.default_rng(4).integers(0, 256, (2, 16))
    with torch.no_grad():
        got = port(torch.tensor(ids)).numpy()
    np.testing.assert_allclose(got, np.asarray(ref(P.to_tensor(ids))._value),
                               atol=1e-4, rtol=1e-4)


def test_default_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        device_mod.resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        GPTForCausalLM(gpt3_tiny())
    assert device_mod.resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        device_mod.resolve_device("meta")


_IMPORT_PATTERN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+paddle_tpu\b(?!_)|"
    r"from\s+paddle_tpu(\.|\s))", re.M)


def test_port_sources_import_neither_jax_nor_reference():
    files = sorted((REPO / "paddle_tpu_torch").rglob("*.py")) + \
        [REPO / "chip_smoke.py"]
    offenders = [str(f.relative_to(REPO)) for f in files
                 if _IMPORT_PATTERN.search(f.read_text())]
    assert not offenders


def test_import_guard_subprocess():
    """Importing every module of the port (and chip_smoke) loads neither
    jax nor the reference package."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import paddle_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, "
        "pkg.__name__ + '.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'paddle_tpu' or "
        "m.startswith('paddle_tpu.')]\n"
        "assert not bad, bad\n"
        "assert len(names) >= 20, names\n"
        "print(len(names))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
