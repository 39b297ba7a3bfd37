"""Seeded GL13 violation: a background loop registered on
RepeatedTask whose callback never opens a root span or a
background_jobs.job() — the work rides no trace, so the durable trace
store can never retain it and information_schema.background_jobs never
shows it running."""


class _RootlessLoop:
    def start(self):
        self._task = RepeatedTask(  # noqa: F821 — parsed, never run
            5.0, self._gl13_sweep_loop, name="rootless")
        self._task.start()

    def _gl13_sweep_loop(self):
        sweep_everything()  # noqa: F821 — stand-in for real work
