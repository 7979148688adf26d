"""Weight bridge, import isolation and device resolution of the port."""
import ast
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from elephas_tpu.models.transformer import TransformerConfig as JaxConfig
from elephas_tpu.models.transformer import init_params as jax_init
from elephas_tpu_torch import DecodeEngine
from elephas_tpu_torch.models.transformer import TransformerConfig
from elephas_tpu_torch.models.transformer import init_params
from elephas_tpu_torch.weights import (from_numpy_tree, to_numpy_tree,
                                       tree_flatten, tree_leaves,
                                       tree_unflatten)

REPO = Path(__file__).resolve().parent.parent
_CFG = dict(vocab_size=64, num_layers=2, num_heads=4, d_model=32, d_ff=64,
            max_seq_len=48)


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


@pytest.mark.parametrize("variant", [{}, {"mlp_variant": "swiglu",
                                          "tied_embedding": False,
                                          "num_kv_heads": 2}])
def test_bridge_round_trip(variant):
    jp = jax_init(JaxConfig(**_CFG, **variant), jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, jp)
    params = from_numpy_tree(tree, device="cpu")
    back = to_numpy_tree(params)
    src, out = dict(_leaves(tree)), dict(_leaves(back))
    assert src.keys() == out.keys()
    for name, a in src.items():
        assert out[name].dtype == a.dtype
        np.testing.assert_array_equal(out[name], a)


def test_bridge_matches_port_init_layout():
    """The bridged JAX tree and the port's own init agree on every key
    and shape, so either feeds the port's functions."""
    variant = dict(_CFG, num_kv_heads=2, mlp_variant="swiglu")
    bridged = from_numpy_tree(jax.tree_util.tree_map(
        np.asarray, jax_init(JaxConfig(**variant), jax.random.PRNGKey(1))),
        device="cpu")
    own = init_params(TransformerConfig(**variant),
                      torch.Generator().manual_seed(1), device="cpu")
    shapes = {k: tuple(v.shape) for k, v in _leaves(own)}
    assert shapes == {k: tuple(v.shape) for k, v in _leaves(bridged)}


def test_tree_leaves_follow_jax_order():
    """Twelve layers: JAX sorts ``layer_10`` before ``layer_2``, and the
    port's flat leaf list follows it leaf for leaf."""
    cfg = dict(_CFG, num_layers=12, tied_embedding=False)
    jp = jax_init(JaxConfig(**cfg), jax.random.PRNGKey(2))
    params = from_numpy_tree(jax.tree_util.tree_map(np.asarray, jp),
                             device="cpu")
    ref = jax.tree_util.tree_leaves(jp)
    leaves, treedef = tree_flatten(params)
    assert len(leaves) == len(ref)
    for a, b in zip(ref, leaves):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    back = tree_unflatten(treedef, [t + 1 for t in leaves])
    np.testing.assert_array_equal(back["layer_10"]["mlp"]["b1"].numpy(),
                                  np.asarray(jp["layer_10"]["mlp"]["b1"]) + 1)
    assert tree_leaves([{"b": 1, "a": 2}, (3,)]) == [2, 1, 3]
    with pytest.raises(ValueError):
        tree_unflatten(treedef, leaves[:-1])


def test_bridge_casts_to_dtype():
    params = from_numpy_tree({"a": {"w": np.ones((2, 3), np.float32)},
                              "ids": np.arange(3)},
                             device="cpu", dtype=torch.bfloat16)
    assert params["a"]["w"].dtype == torch.bfloat16
    assert params["ids"].dtype == torch.int64
    assert to_numpy_tree(params)["a"]["w"].dtype == np.float32


def test_port_runs_without_jax_or_the_jax_package():
    """A fresh interpreter imports the port and serves one request on the
    CPU; neither jax nor elephas_tpu is ever loaded."""
    code = """
import sys, torch
import elephas_tpu_torch as etp
cfg = etp.TransformerConfig(vocab_size=32, num_layers=1, num_heads=2,
                            d_model=16, d_ff=32, max_seq_len=24,
                            dtype=torch.float32)
params = etp.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
eng = etp.DecodeEngine(params, cfg, max_slots=2, paged=(8, 4),
                       kernel="fused", device="cpu")
out = eng.run([[1, 2, 3]], 3)
assert len(out[0]) == 3, out
bad = [m for m in sys.modules
       if m.split(".")[0] in ("jax", "jaxlib", "elephas_tpu")]
assert not bad, bad
print("ok")
"""
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_no_source_of_the_port_imports_jax():
    files = sorted((REPO / "elephas_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    for path in files:
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in (
                    "jax", "jaxlib", "optax", "elephas_tpu"), (path, name)


def test_device_none_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = TransformerConfig(**_CFG)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_params(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="CUDA"):
        from_numpy_tree({"w": np.ones(2, np.float32)})
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        DecodeEngine(params, cfg, paged=(8, 8))
