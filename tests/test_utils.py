"""utils: profiling, metrics, checkpoint round-trip."""
import numpy as np
import jax.numpy as jnp

from mpc_blaster_tpu.utils.checkpoint import load_pytree, save_pytree
from mpc_blaster_tpu.utils.metrics import summarize
from mpc_blaster_tpu.utils.profiling import Timer
from mpc_blaster_tpu.sqp.rti import RTIState


def test_timer_percentiles():
    t = Timer()
    for v in [0.001, 0.002, 0.003]:
        t.add("solve", v)
    s = t.summary("solve")
    assert s["count"] == 3
    assert 1.9 < s["p50_ms"] < 2.1
    with t.measure("ctx"):
        pass
    assert t.summary("ctx")["count"] == 1


def test_checkpoint_roundtrip(tmp_path):
    state = RTIState(xbar=jnp.arange(12.0).reshape(3, 4),
                     ubar=jnp.ones((2, 4)) * 7)
    path = str(tmp_path / "ckpt.npz")
    save_pytree(path, state)
    like = RTIState(xbar=jnp.zeros((3, 4)), ubar=jnp.zeros((2, 4)))
    restored = load_pytree(path, like)
    np.testing.assert_allclose(np.asarray(restored.xbar),
                               np.asarray(state.xbar))
    np.testing.assert_allclose(np.asarray(restored.ubar),
                               np.asarray(state.ubar))


def test_checkpoint_orbax_sharded_roundtrip(tmp_path):
    """Orbax path: save/restore a SHARDED global array onto its mesh —
    the pod-scale sweep resume (single .npz can't do per-host shards)."""
    import jax
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from mpc_blaster_tpu.utils.checkpoint import (load_pytree_orbax,
                                                  save_pytree_orbax)

    devs = np.array(jax.devices()[:8]).reshape(8)
    mesh = Mesh(devs, ("dp",))
    sharding = NamedSharding(mesh, P("dp"))
    x = jax.device_put(jnp.arange(16.0).reshape(16, 1) * 3.0, sharding)
    tree = {"x": x, "step": jnp.asarray(7)}
    path = str(tmp_path / "orbax_ckpt")
    save_pytree_orbax(path, tree)

    like = {"x": jax.device_put(jnp.zeros((16, 1)), sharding),
            "step": jnp.asarray(0)}
    restored = load_pytree_orbax(path, like)
    assert restored["x"].sharding == sharding
    np.testing.assert_allclose(np.asarray(restored["x"]), np.asarray(x))
    assert int(restored["step"]) == 7


def test_metrics_summary_healthy():
    class R:
        xs = np.zeros((11, 17))
        us = np.zeros((10, 6))
        kkt_stat = np.full(10, 1e-7)
        kkt_eq = np.full(10, 1e-9)
        costs = np.linspace(10, 1, 10)
    s = summarize(R())
    assert s.healthy
    assert s.n_solves == 10
    js = s.to_json()
    assert "kkt_stat_max" in js


def test_device_time_measures_positive():
    """utils/timing.py: the host-clock timer returns one positive sample
    per call, waits on each call's outputs, and device_time is their
    median."""
    import time

    import jax
    import jax.numpy as jnp
    from mpc_blaster_tpu.utils.timing import call_times, device_time

    f = jax.jit(lambda x: jnp.sin(x).sum())
    x = jnp.ones((256, 256), jnp.float32)
    ts = call_times(lambda: f(x), reps=5, warmup=1)
    assert ts.shape == (5,) and (ts > 0.0).all()
    assert device_time(lambda: f(x), reps=5) > 0.0

    def slow():
        time.sleep(0.01)
        return f(x)
    assert device_time(slow, reps=3, warmup=0) >= 0.01
