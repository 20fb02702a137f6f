"""The port's profiling hooks (``marlnav_tpu_torch/utils/profiling.py``)
against the JAX package's: ``Throughput`` and ``checked_step`` as
tests/test_utils_misc.py pins them, ``checked_step`` flagging exactly what
``checkify.float_checks`` flags on the same functions, and ``trace``
writing a trace that names its ``annotate`` regions."""

import glob
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import checkify

from marlnav_tpu_torch.config import EnvParams, TriangleInitConfig
from marlnav_tpu_torch.env import make_env
from marlnav_tpu_torch.utils import Throughput, annotate, checked_step, trace
from marlnav_tpu_torch.utils.seeding import make_generator


def test_throughput_meter():
    t = Throughput()
    t.tick(0)
    x = torch.ones(8) * 2
    rate = t.tick(100, x)
    assert rate > 0 and t.steps == 100 and t.rate > 0
    with Throughput() as t2:
        t2.tick(10, {"a": [x]})
    assert t2.steps == 10 and t2.seconds > 0


def test_checked_step_passes_clean_env():
    env = make_env(EnvParams(num_parallel=4), TriangleInitConfig(
        num_parallel=4), "cpu")
    state = env.init(make_generator(0))
    err, (state2, out) = checked_step(env.step)(state, torch.zeros(4, 3, 2))
    err.throw()  # no NaN or division by zero in a healthy step
    assert err.get() is None
    assert torch.isfinite(out.rewards).all()


def test_checked_step_catches_nan():
    err, out = checked_step(lambda x: torch.log(x))(torch.tensor(-1.0))
    assert torch.isnan(out)
    with pytest.raises(FloatingPointError, match="nan generated by"):
        err.throw()


# name -> (jax function, port function, input): the seven probes of
# checkify.float_checks, and a clean function.
PROBES = {
    "log(-1)": (lambda x: jnp.log(-x), lambda x: torch.log(-x), 1.0),
    "masked log": (lambda x: jnp.where(x < 0, jnp.log(-x), 0.0),
                   lambda x: torch.where(x < 0, torch.log(-x), 0.0), 2.0),
    "x * nan": (lambda x: x * jnp.nan, lambda x: x * float("nan"), 2.0),
    "x / 0.": (lambda x: x / 0.0, lambda x: x / 0.0, 2.0),
    "3 // 0": (lambda x: jnp.asarray(3) // 0, lambda x: torch.tensor(3) // 0,
               2.0),
    "exp(1000) - exp(1000)": (lambda x: jnp.exp(x) - jnp.exp(x),
                              lambda x: torch.exp(x) - torch.exp(x), 1000.0),
    "exp(1000)": (jnp.exp, torch.exp, 1000.0),
    "clean": (lambda x: x * 2.0 + 1.0, lambda x: x * 2.0 + 1.0, 3.0),
}


@pytest.mark.parametrize("name", list(PROBES))
def test_checked_step_flags_as_checkify(name):
    """The port flags a probe exactly where checkify with float_checks
    gives an error."""
    j_fn, t_fn, x = PROBES[name]
    j_err, _ = checkify.checkify(j_fn, errors=checkify.float_checks)(
        jnp.float32(x))
    t_err, _ = checked_step(t_fn)(torch.tensor(x, dtype=torch.float32))
    assert (t_err.get() is not None) == (j_err.get() is not None), (
        name, t_err.get(), j_err.get())
    assert (j_err.get() is not None) == (name not in ("exp(1000)", "clean"))


def test_trace_names_annotate_region(tmp_path):
    """``trace`` writes a TensorBoard / Perfetto JSON trace under its
    directory, naming the ``annotate`` region."""
    with trace(str(tmp_path / "prof")):
        with annotate("marlnav_region"):
            torch.ones(64).cumsum(0)
    (path,) = glob.glob(str(tmp_path / "prof" / "*.pt.trace.json"))
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    assert any(e.get("name") == "marlnav_region" for e in events)


def test_exports_match_jax_package():
    import marlnav_tpu.utils as j_utils

    import marlnav_tpu_torch.utils as t_utils

    for name in ("Throughput", "annotate", "checked_step", "trace"):
        assert name in j_utils.__all__ and name in t_utils.__all__
    assert np.isfinite(Throughput().rate)
