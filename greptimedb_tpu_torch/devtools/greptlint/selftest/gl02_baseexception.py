"""Seeded GL02 violation: BaseException caught and not re-raised, so a
SimulatedCrash (which must behave like SIGKILL) would survive."""

import logging

logger = logging.getLogger(__name__)


def run_job(job):
    try:
        job()
    except BaseException:
        logger.exception("job failed")  # logged (GL01-clean) but swallowed
