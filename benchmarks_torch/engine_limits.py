"""The JAX package's own results on the jobs of chip_smoke.py's engine phase.

    PYTHONPATH=src JAX_PLATFORMS=cpu python -m benchmarks_torch.engine_limits

Builds the job specs of the phase's two solve_server runs
(``chip_smoke.ENGINE_MAIN`` and ``ENGINE_SANITIZED``) as the port's
``solve_server`` builds them, solves each with the JAX package's
``abo_minimize`` on the CPU, and prints each job's fun, then one JSON line
with the largest fun of each (objective, n): the values
``chip_smoke.ENGINE_JAX_FUN`` holds. A job of the phase is held to 1e-6, or
where the JAX package misses that, to its value x 1.001. About 5 minutes on
a CPU (the three n = 4e6 solves take most of it).

    PYTHONPATH=src JAX_PLATFORMS=cpu python -m benchmarks_torch.engine_limits --x64

does the same for the float64 phase (``chip_smoke.F64_N`` and
``F64_ENGINE``) under ``jax.enable_x64(True)`` with ``dtype=jnp.float64``:
the values ``chip_smoke.F64_JAX_FUN`` holds. About 2 minutes on a CPU.
"""
from __future__ import annotations

import dataclasses
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def smoke_specs():
    """(objective, n, seed, config fields) of every job the engine phase
    submits."""
    import chip_smoke
    from repro_torch.core.abo import ABOConfig
    from repro_torch.launch import solve_server
    out = []
    for argv in (chip_smoke.ENGINE_MAIN, chip_smoke.ENGINE_SANITIZED):
        a = solve_server._parser().parse_args(argv)
        cfg = ABOConfig(samples_per_pass=a.samples, n_passes=a.passes,
                        block_size=a.block)
        ns = [int(v) for v in a.n.split(",")]
        out += [(s.objective, s.n, s.seed, dataclasses.asdict(s.config))
                for s in solve_server._mixed_specs(
                    a.jobs, a.objectives.split(","), ns, cfg)]
    return out


def main() -> dict:
    from repro.core.abo import ABOConfig, abo_minimize
    from repro.objectives import OBJECTIVES
    worst: dict = {}
    for name, n, seed, cfg in smoke_specs():
        t0 = time.perf_counter()
        fun = float(abo_minimize(OBJECTIVES[name], n, config=ABOConfig(**cfg),
                                 seed=seed).fun)
        print(f"{name} n={n} seed={seed}: fun {fun!r} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
        key = f"{name},{n}"
        worst[key] = max(worst.get(key, fun), fun)
    print(json.dumps(worst))
    return worst


def main_x64() -> dict:
    import jax
    import jax.numpy as jnp

    import chip_smoke
    from repro.core.abo import abo_minimize
    from repro.objectives import OBJECTIVES
    jobs = [("griewank", chip_smoke.F64_N, 0)] + [
        (name, n, seed) for name, n, seed in chip_smoke.F64_ENGINE]
    out: dict = {}
    with jax.enable_x64(True):
        for name, n, seed in jobs:
            t0 = time.perf_counter()
            fun = float(abo_minimize(OBJECTIVES[name], n, dtype=jnp.float64,
                                     seed=seed).fun)
            print(f"{name} n={n} seed={seed} float64 under x64: fun {fun!r} "
                  f"({time.perf_counter() - t0:.1f} s)", flush=True)
            out[f"{name},{n},{seed}"] = fun
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main_x64() if "--x64" in sys.argv[1:] else main()
