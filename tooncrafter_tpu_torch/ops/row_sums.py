"""The pieces the plans of the two kernels on ``csrc/row_sums.cuh`` share
(the one-pass GroupNorm, ``ops/fused_norms.plan``, and the channel sums,
``ops/stats.plan``): the ring's stages, the threads of a block and the
H100's shared memory. A block's threads are (16-byte column, row offset)
pairs; a stage is a whole number of rstep-row groups, so each thread keeps
its column."""

from __future__ import annotations

MAX_SLOTS = 32                     # mbarriers a block keeps
BAR_BYTES = 8 * MAX_SLOTS
STAGE_BYTES = 16384                # a stage, about
ROW_THREADS = 256                  # threads a block aims for
RING_SLOTS = 4                     # a ring's stages in flight
SMEM_BLOCK = 232448                # a block's shared memory on the H100
SMEM_SM = 233472                   # an SM's
SMEM_RESERVED = 1024               # the runtime's share of each block


def row_step(cv: int) -> int:
    """Row offsets a block walks with, for cv 16-byte columns a row: about
    ROW_THREADS threads."""
    return 1 if cv >= ROW_THREADS else ROW_THREADS // cv


def stage_rows(rstep: int, row_bytes: int,
               stage_bytes: int = STAGE_BYTES) -> int:
    """Rows a ring stage: whole groups of rstep rows, about stage_bytes."""
    return rstep * max(1, stage_bytes // (rstep * row_bytes))


def blocks_an_sm(smem: int, threads: int) -> int:
    """Blocks of ``smem`` dynamic shared-memory bytes an SM holds."""
    return min(SMEM_SM // (smem + SMEM_RESERVED), 2048 // threads)
