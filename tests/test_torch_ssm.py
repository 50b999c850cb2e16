"""The port's selective-SSM heads (``models/ssm.py``) against the JAX
package's ``models/ssm.py``, on the CPU, at smoke size
(``reduce_for_smoke(get_config("hymba-1.5b"))``: d_model 80, 5 SSM heads of
32 channels, state size 4, conv width 4, SSD chunks of 16), on bridged
weights and inputs made from a seed with numpy.

* ``_conv1d`` from a zero and from a given state: outputs and new states
  to 1e-6 of their largest value (the same K products summed in the same
  order).
* ``ssm_mix`` at S a multiple of the chunk (two and three chunks carry the
  state from one to the next) and not a multiple (one chunk of S), from a
  zero and from a given state: outputs and both states to 2e-6 of their
  largest value (einsums that sum the same terms in another order).
* ``ssm_step`` from given states, to 2e-6.
* The scan against the step: ``ssm_mix`` over S + 1 tokens equals
  ``ssm_mix`` over S followed by ``ssm_step``, in the port alone, to 2e-6
  (the chunked form takes its decays from a cumulative sum, the step from
  one product; 4e-7 measured).
* The init kinds: ``ssm_a`` equals the JAX package's ``log(1..N)``;
  ``ssm_dt`` draws from the ``torch.Generator`` (other bits than
  ``jax.random``), its softplus lies in [1e-3, 1e-1] and is log-uniform
  there; the hybrid layer's parameter tree has the JAX package's names,
  shapes and init kinds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config.model import reduce_for_smoke as jax_reduce
from repro.configs import get_config as jax_get_config
from repro.models import init_params as jax_init_params
from repro.models import param_specs as jax_param_specs
from repro.models import ssm as jax_ssm
from repro.models.layers import ParamSpec as JaxSpec
from repro.models.layers import materialize as jax_materialize
from repro_torch.bridge import params_from_jax
from repro_torch.config import reduce_for_smoke
from repro_torch.configs import get_config
from repro_torch.models import init_params, param_specs, ssm
from repro_torch.models.layers import ParamSpec, materialize

torch.set_num_threads(2)

ARCH = "hymba-1.5b"


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = jax_reduce(jax_get_config(ARCH)), reduce_for_smoke(get_config(ARCH))
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    tparams = params_from_jax(tcfg, jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, tcfg, jparams, tparams


def _rel(got: torch.Tensor, ref) -> float:
    ref = np.asarray(ref)
    return float(np.max(np.abs(got.numpy() - ref))) / max(float(np.max(np.abs(ref))), 1e-30)


def _ssm_params(jparams, tparams, layer=0):
    return jax.tree.map(lambda a: a[layer], jparams["blocks"])["ssm"], tparams["blocks"][layer]["ssm"]


def _states(cfg, B, seed):
    rng = np.random.default_rng(seed)
    K, di = cfg.ssm.conv_width, ssm.d_inner(cfg)
    H, P, N = cfg.num_heads, ssm.head_dim_inner(cfg), cfg.ssm.state_size
    conv = rng.standard_normal((B, K - 1, di)).astype(np.float32)
    h = (0.5 * rng.standard_normal((B, H, P, N))).astype(np.float32)
    return conv, h


def test_smoke_shapes(models):
    _, tcfg, _, _ = models
    assert (tcfg.d_model, tcfg.num_heads, tcfg.num_kv_heads, tcfg.sliding_window) == (80, 5, 1, 32)
    assert (ssm.d_inner(tcfg), ssm.head_dim_inner(tcfg), tcfg.ssm.state_size, tcfg.ssm.chunk_size) == (160, 32, 4, 16)


@pytest.mark.parametrize("with_state", [False, True], ids=["zero_state", "given_state"])
def test_conv1d_matches_jax(models, with_state):
    jcfg, tcfg, jparams, tparams = models
    jp, tp = _ssm_params(jparams, tparams)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 11, ssm.d_inner(tcfg))).astype(np.float32)
    state = _states(tcfg, 2, 2)[0] if with_state else None
    jy, jst = jax_ssm._conv1d(jnp.asarray(x), jp["conv_w"], jp["conv_b"], None if state is None else jnp.asarray(state))
    ty, tst = ssm._conv1d(torch.from_numpy(x), tp["conv_w"], tp["conv_b"], None if state is None else torch.from_numpy(state))
    assert _rel(ty, jy) < 1e-6 and _rel(tst, jst) < 1e-6
    assert tst.shape == (2, tcfg.ssm.conv_width - 1, ssm.d_inner(tcfg))
    assert np.array_equal(tst.numpy(), x[:, -(tcfg.ssm.conv_width - 1):])  # the last K - 1 inputs


@pytest.mark.parametrize("S", [16, 32, 48, 20, 5], ids=lambda s: f"S{s}")
@pytest.mark.parametrize("with_state", [False, True], ids=["zero_state", "given_state"])
def test_ssm_mix_matches_jax(models, S, with_state):
    """S = 16, 32, 48 run one, two and three chunks of 16; S = 20 and 5 are
    not multiples, so each is one chunk of S, as in the JAX package."""
    jcfg, tcfg, jparams, tparams = models
    jp, tp = _ssm_params(jparams, tparams, layer=1)
    rng = np.random.default_rng(S)
    x = rng.standard_normal((2, S, tcfg.d_model)).astype(np.float32)
    conv, h = _states(tcfg, 2, S + 7) if with_state else (None, None)
    jkw = {} if conv is None else dict(conv_state=jnp.asarray(conv), ssm_state=jnp.asarray(h))
    tkw = {} if conv is None else dict(conv_state=torch.from_numpy(conv), ssm_state=torch.from_numpy(h))
    jout, (jconv, jh) = jax_ssm.ssm_mix(jcfg, jp, jnp.asarray(x), **jkw)
    tout, (tconv, th) = ssm.ssm_mix(tcfg, tp, torch.from_numpy(x), **tkw)
    assert _rel(tout, jout) < 2e-6
    assert _rel(tconv, jconv) < 1e-6
    assert _rel(th, jh) < 2e-6
    assert th.dtype == torch.float32 and th.shape == tuple(jh.shape)


def test_ssm_step_matches_jax(models):
    jcfg, tcfg, jparams, tparams = models
    jp, tp = _ssm_params(jparams, tparams)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((3, 1, tcfg.d_model)).astype(np.float32)
    conv, h = _states(tcfg, 3, 4)
    jout, (jconv, jh) = jax_ssm.ssm_step(jcfg, jp, jnp.asarray(x), jnp.asarray(conv), jnp.asarray(h))
    tout, (tconv, th) = ssm.ssm_step(tcfg, tp, torch.from_numpy(x), torch.from_numpy(conv), torch.from_numpy(h))
    assert _rel(tout, jout) < 2e-6 and _rel(tconv, jconv) < 1e-6 and _rel(th, jh) < 2e-6


@pytest.mark.parametrize("S", [16, 21], ids=["S16_chunked", "S21_one_chunk"])
def test_scan_then_step_equals_scan(models, S):
    """The chunked scan over S + 1 tokens against the scan over S and one
    step: the last output and both states, within 2e-6 of their largest."""
    _, tcfg, _, tparams = models
    tp = tparams["blocks"][0]["ssm"]
    x = torch.from_numpy(np.random.default_rng(9).standard_normal((2, S + 1, tcfg.d_model)).astype(np.float32))
    full, (conv_full, h_full) = ssm.ssm_mix(tcfg, tp, x)
    _, (conv, h) = ssm.ssm_mix(tcfg, tp, x[:, :S])
    last, (conv_step, h_step) = ssm.ssm_step(tcfg, tp, x[:, S:], conv, h)
    for got, want in ((last, full[:, S:]), (conv_step, conv_full), (h_step, h_full)):
        assert _rel(got, want.numpy()) < 2e-6


def test_ssm_a_matches_jax():
    spec = ParamSpec((5, 4), ("heads", None), "ssm_a")
    a = materialize(spec, torch.Generator().manual_seed(0), "cpu", torch.float32)
    ja = jax_materialize(JaxSpec((5, 4), ("heads", None), "ssm_a"), jax.random.PRNGKey(0), jnp.float32)
    assert np.array_equal(a.numpy(), np.asarray(ja))
    assert np.allclose(-np.exp(a.numpy()[0]), -np.arange(1, 5))  # A = -(1..N)


def test_ssm_dt_is_log_uniform():
    """softplus(bias) lies in [1e-3, 1e-1], log-uniform: its log spreads
    evenly over [log 1e-3, log 1e-1] (mean and quartiles within 0.1 of a
    uniform's at 4096 draws); the bits come from the generator."""
    spec = ParamSpec((4096,), ("heads",), "ssm_dt")
    b = materialize(spec, torch.Generator().manual_seed(0), "cpu", torch.float32)
    dt = torch.nn.functional.softplus(b.double())
    assert float(dt.min()) >= 1e-3 * (1 - 1e-5) and float(dt.max()) <= 1e-1 * (1 + 1e-5)
    u = (torch.log(dt) - np.log(1e-3)) / (np.log(1e-1) - np.log(1e-3))
    assert abs(float(u.mean()) - 0.5) < 0.1
    assert abs(float(torch.quantile(u, 0.25)) - 0.25) < 0.1 and abs(float(torch.quantile(u, 0.75)) - 0.75) < 0.1
    again = materialize(spec, torch.Generator().manual_seed(0), "cpu", torch.float32)
    other = materialize(spec, torch.Generator().manual_seed(1), "cpu", torch.float32)
    assert torch.equal(b, again) and not torch.equal(b, other)


def test_hybrid_param_tree_matches_jax(models):
    """Names, shapes and init kinds of a hybrid layer's parameters equal the
    JAX package's (whose layers are stacked on a leading axis)."""
    jcfg, tcfg, _, _ = models
    jl = jax_param_specs(jcfg)["blocks"]
    tl = param_specs(tcfg)["blocks"][0]

    def flat(tree, prefix=""):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out.update(flat(v, f"{prefix}{k}/"))
            else:
                out[prefix + k] = v
        return out

    jf, tf = flat(jl), flat(tl)
    assert set(jf) == set(tf)
    assert {"ssm/a_log", "ssm/dt_bias", "ssm/conv_w", "beta_attn", "beta_ssm", "norm2/scale"} <= set(tf)
    for name, spec in tf.items():
        assert (jf[name].shape[1:], jf[name].init, jf[name].scale) == (spec.shape, spec.init, spec.scale), name
    p = init_params(tcfg, 0, device="cpu")["blocks"][0]
    assert np.array_equal(p["ssm"]["a_log"].numpy(), np.broadcast_to(np.log(np.arange(1.0, 5.0)), (5, 4)).astype(np.float32))
    assert bool((torch.nn.functional.softplus(p["ssm"]["dt_bias"]) <= 0.1 + 1e-6).all())
