"""Seeded GL11 violation: a cohort-wait loop (the WAL group-commit /
ingest-coalescer shape) that parks on an event with neither a bounded
timeout nor a cancellation point — a dead leader wedges every follower
forever and KILL cannot interrupt the park. The interprocedural
I/O-loop form of GL11 is seeded by
tests/test_torch_greptlint.py::test_gl11_fires_without_check_and_clears_with_it."""


def follow_cohort(batch):
    while not batch.done.is_set():     # the unbounded cohort wait
        batch.done.wait()
    return batch.result
