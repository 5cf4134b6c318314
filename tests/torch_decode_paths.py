"""The port's decode paths as test parameters, each with the JAX config that
is its reference (shared by the tests of the distributed path).

- "ragged": `tiny` at the port's default, which resolves to the ragged
  kernel (its plain version on the CPU); JAX on the gather window
  (`decode_kernel="off"`), which the kernel equals in f32.
- "gather": `tiny` with `decode_kernel="off"` in both packages.
- "gemma2" / "gemma2-all": tests/test_torch_gemma2.py's tiny Gemma-2
  geometry (post norms, both soft-caps, the query scale, a 6-token sliding
  window on alternating / all layers), whose knobs send the port's "auto"
  to the gather window; JAX at its default (the gather window). Its norms
  are redrawn around their init from numpy seed 0, so every knob moves the
  output.

All in float32. `env(path)` returns (JAX config, port config, JAX params as
numpy, port params on the CPU), made once per path and process.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np

from dynamo_tpu.engine.config import ModelConfig as JModelConfig
from dynamo_tpu.models import llama as jllama
from dynamo_tpu_torch.engine.config import ModelConfig as TModelConfig
from dynamo_tpu_torch.models import llama as tllama

PATHS = ("ragged", "gather", "gemma2")
GATHER_PATHS = ("gather", "gemma2", "gemma2-all")
MAX_LEN = 512
GEMMA2 = dict(vocab_size=192, hidden_size=64, intermediate_size=96,
              num_layers=3, num_heads=4, num_kv_heads=2, head_dim=16,
              embed_scale=64 ** 0.5, norm_plus_one=True,
              mlp_act="gelu_tanh", tie_word_embeddings=True,
              post_norms=True, final_softcap=3.0, attn_softcap=5.0,
              query_scale=32 ** -0.5, sliding_window=6)

_ENVS = {}


def configs(path: str, max_model_len: int = MAX_LEN):
    base = dict(dtype="float32", max_model_len=max_model_len)
    if path == "ragged":
        return (JModelConfig(**base, decode_kernel="off"),
                TModelConfig(**base))
    if path == "gather":
        return (JModelConfig(**base, decode_kernel="off"),
                TModelConfig(**base, decode_kernel="off"))
    pattern = "all" if path == "gemma2-all" else "alternate"
    kw = dict(base, **GEMMA2, sliding_pattern=pattern)
    return JModelConfig(**kw), TModelConfig(**kw)


def _tree(jcfg, path):
    # jitted, as the JAX engine draws its seed-0 weights
    init = jax.jit(functools.partial(jllama.init_params, cfg=jcfg))
    tree = jax.device_get(init(jax.random.PRNGKey(0)))
    if not path.startswith("gemma2"):
        return tree
    rng = np.random.default_rng(0)
    layers = {k: (rng.uniform(-0.5, 0.5, v.shape).astype(np.float32)
                  if k.endswith("norm") else v)
              for k, v in tree["layers"].items()}
    return dict(tree, layers=layers, final_norm=rng.uniform(
        -0.5, 0.5, tree["final_norm"].shape).astype(np.float32))


def env(path: str, max_model_len: int = MAX_LEN):
    key = (path, max_model_len)
    if key not in _ENVS:
        jcfg, tcfg = configs(path, max_model_len)
        tree = _tree(jcfg, path)
        _ENVS[key] = (jcfg, tcfg, tree,
                      tllama.params_from_jax(tree, tcfg, "cpu"))
    return _ENVS[key]


def jax_params(tree):
    """The numpy tree as JAX arrays (one upload per engine)."""
    return jax.tree_util.tree_map(jnp.asarray, tree)


def expected_path(path: str) -> str:
    return "ragged" if path == "ragged" else "gather"


def check_path(tengine, path: str) -> None:
    """The port engine took the path the parameter names."""
    assert tengine.decode_path == expected_path(path), \
        (tengine.decode_path, path)


