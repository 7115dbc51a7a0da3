"""Benchmark: NMPC RTI solves/s on one GPU + B=1 tick latency rows.

    python bench.py     # on a GPU; prints ONE JSON line

  {"metric": ..., "value": ..., "unit": ..., "vs_baseline": ..., ...}

Baseline definition (BASELINE.md): the reference controller's real-time
loop runs one SQP-RTI solve per 33.3 ms discretization step
(`simulation_blaster.py:19-20`) — 30 solves/s sustained is what the
reference system needs and achieves on CPU. `value` is the batched
solves/s of one card (B=4096 scenarios, N=20, `safe` profile) and
vs_baseline is that divided by 30 solves/s.

Rows:
  batched4096_n20_ms_per_tick   median of 20 batched ticks
  <profile>_n<N>_p50_ms/_p90_ms B=1 `make_rti_step` tick of the simulation
                                preset, 200 ticks, at the `safe` profile
                                for N=20/30/60 and the `fast` one at N=60

Times are the host clock around calls that end in `block_until_ready`
(`utils/timing.py`); compile time is reported apart, as set-up. These are
the programs `chip_smoke.py` checks against a float64 reference, built the
same way, so a warm compile cache serves both. A failed row reports its
error in the JSON line and the others still run. The script refuses to run
anywhere but on a GPU: a CPU number is never reported under a device
metric.
"""
import dataclasses
import json
import sys
import time

import numpy as np

import jax
import jax.numpy as jnp


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def err_s(e):
    """One short ASCII line for an exception (no control bytes, so the
    result line stays one parseable JSON line)."""
    s = " ".join(str(e).split())
    s = "".join(ch for ch in s if 32 <= ord(ch) < 127)
    return s[:120]


def main():
    from mpc_blaster_tpu import config as cfg
    from mpc_blaster_tpu.ocp.spec import build_spec
    from mpc_blaster_tpu.parallel.mesh import batched_rti_step
    from mpc_blaster_tpu.sim.closedloop import preset_stage_params
    from mpc_blaster_tpu.sqp.rti import init_rti_state, make_rti_step
    from mpc_blaster_tpu.utils.cache import enable_compile_cache
    from mpc_blaster_tpu.utils.timing import call_times, card_identity

    devices = jax.devices()
    dev = devices[0]
    if dev.platform != "gpu":
        sys.exit(f"bench: needs an NVIDIA GPU; JAX found {len(devices)} "
                 f"{dev.platform} device(s) ({dev.device_kind})")
    log(f"bench: compile cache {enable_compile_cache()}")

    dtype = jnp.float32
    preset = cfg.simulation_preset()
    out = {}

    def sim_ocp(N, profile):
        return dataclasses.replace(preset.ocp, N=N, Tf=N / 30.0,
                                   solver=cfg.deployed_solver(profile))

    def compiled(fn, *args):
        t0 = time.perf_counter()
        exe = fn.lower(*args).compile()
        return exe, time.perf_counter() - t0

    # ---- batched throughput: B scenarios, one tick per call ----
    B, N = 4096, 20
    try:
        log(f"bench: batched B={B} N={N}")
        ocp = sim_ocp(N, "safe")
        spec = build_spec(ocp, yref=preset.loop.yref, dtype=dtype)
        rng = np.random.default_rng(0)
        x0s = np.zeros((B, cfg.NX))
        x0s[:, 0:3] = rng.uniform(-0.4, 0.4, (B, 3))
        x0s[:, 2] += 2.0
        xs = jnp.asarray(x0s, dtype)
        states = jax.vmap(lambda x: init_rti_state(ocp, x, dtype))(xs)
        step, t_c = compiled(batched_rti_step(ocp, dtype=dtype), spec,
                             states, xs)
        t = float(np.median(call_times(lambda: step(spec, states, xs),
                                       reps=20, warmup=3)))
        out["batched4096_n20_ms_per_tick"] = t * 1e3
        out["batched4096_n20_compile_s"] = t_c
        out["batched4096_solves_per_s"] = B / t
    except Exception as e:
        out["batched4096_solves_per_s"] = 0.0
        out["batched4096_error"] = err_s(e)

    # ---- B=1 tick latency of the deployed profiles ----
    x0 = jnp.asarray(preset.loop.x0, dtype)
    for profile, N in (("safe", 20), ("safe", 30), ("safe", 60),
                       ("fast", 60)):
        name = f"{profile}_n{N}"
        try:
            log(f"bench: {name} B=1 tick")
            ocp = sim_ocp(N, profile)
            spec = build_spec(ocp, yref=preset.loop.yref,
                              stage_params=preset_stage_params(preset, dtype),
                              dtype=dtype)
            st = init_rti_state(ocp, x0, dtype)
            tick, t_c = compiled(make_rti_step(ocp, dtype=dtype), spec, st,
                                 x0)
            ts = call_times(lambda: tick(spec, st, x0), reps=200,
                            warmup=10)
            out[f"{name}_p50_ms"] = float(np.percentile(ts, 50)) * 1e3
            out[f"{name}_p90_ms"] = float(np.percentile(ts, 90)) * 1e3
            out[f"{name}_compile_s"] = t_c
        except Exception as e:
            out[f"{name}_error"] = err_s(e)

    best = out["batched4096_solves_per_s"]
    baseline_rate = 30.0  # reference real-time solve rate (33.3 ms/tick)
    final = {
        "metric": "nmpc_rti_solves_per_sec_per_card_N20",
        "value": best,
        "unit": "solves/s",
        "vs_baseline": best / baseline_rate,
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "device_count": len(devices),
        "card": card_identity(),
    }
    final.update(out)
    print(json.dumps(final, separators=(",", ":")), flush=True)


if __name__ == "__main__":
    main()
