"""Bytes-moved accounting for the engine: the analytic model.

Port of :func:`repro.obs.roofline.plan_pass_bytes`. A coordinate-sweep pass
streams the working set through memory, so one executed (lane, block-row)
sweep slot reads its coordinate block once and writes it back once, and
the end-of-pass lane sync gathers every active lane's full row view once
more for the exact aggregate re-sync::

    pass_bytes = 2 * swept_slots * block * itemsize        (sweep)
               + prod(sync_table_shape) * block * itemsize  (sync gather)

This is what the engine adds to ``engine_est_bytes_moved_total`` at each
dispatch: host arithmetic on plan shapes, never a device read. The HLO
cross-check and the measured-peak probe of the reference wait for the
port's benchmarks.
"""
from __future__ import annotations


def plan_pass_bytes(plan, block_size: int, itemsize: int) -> int:
    """Estimated device-memory bytes one pass of this sweep plan moves."""
    if plan is None or plan.sync is None:
        return 0
    sweep = 2 * plan.swept_slots * block_size * itemsize
    sync_rows = 1
    for d in plan.sync.pages.shape:
        sync_rows *= int(d)
    return sweep + sync_rows * block_size * itemsize
