"""Test-side changes to the JAX package where it cannot run a path, so
that the port is still held to the JAX package's arithmetic. Each function
patches for the duration of a `pytest.MonkeyPatch`; nothing in the JAX
package itself changes.
"""

import types


def jax_biphasic_with_ka2(jlik, monkeypatch):
    """The JAX package's biphasic path calls linear_pk.propagate_biphasic
    without its ka2 argument (bcm3_tpu/likelihoods/poppk.py:420-422,
    :449-458), so every argument after ka1 shifts by one and the call
    raises TypeError. This passes the chain's ka2 (from the JAX package's
    own `_patient_params`) into that call; nothing else changes."""
    from bcm3_tpu.likelihoods import poppk as jpoppk
    from bcm3_tpu.ode import linear_pk as jlpk

    model = jlik.model
    cell = {}
    params = model._patient_params

    def patient_params(values):
        out = params(values)
        cell["ka2"] = out[0]["ka2"]
        return out

    def propagate_biphasic(y, dt, sw, ka1, ke, kel, kpf, kpb):
        return jlpk.propagate_biphasic(y, dt, sw, ka1, cell["ka2"], ke, kel, kpf, kpb)

    shim = types.SimpleNamespace(
        **{k: getattr(jlpk, k) for k in dir(jlpk) if not k.startswith("__")}
    )
    shim.propagate_biphasic = propagate_biphasic
    monkeypatch.setattr(model, "_patient_params", patient_params)
    monkeypatch.setattr(jpoppk, "linear_pk", shim)


def jax_dp5_zero_safe_sqrt(monkeypatch):
    """The JAX package's budgeted DP5 takes its error norm as
    jnp.sqrt(jnp.mean(...)) and then jnp.where(remaining > 0, err_norm,
    0.0) (bcm3_tpu/ode/dp5.py:308-310). A lane past its last stop has a
    zero remainder, and the reverse mode of sqrt at 0 multiplies the zero
    cotangent by inf: every gradient through the solve is NaN. This swaps
    dp5's `jnp` for a namespace whose sqrt is zero-safe (the double-where:
    0 with a zero derivative where the argument is exactly 0, every value
    sqrt's), as the port's ode/dp5.py `_safe_sqrt`; nothing else changes."""
    import jax.numpy as jnp

    from bcm3_tpu.ode import dp5 as jdp5

    def sqrt(x):
        zero = x == 0
        return jnp.where(zero, 0.0, jnp.sqrt(jnp.where(zero, 1.0, x)))

    shim = types.SimpleNamespace(
        **{k: getattr(jnp, k) for k in dir(jnp) if not k.startswith("__")}
    )
    shim.sqrt = sqrt
    monkeypatch.setattr(jdp5, "jnp", shim)
