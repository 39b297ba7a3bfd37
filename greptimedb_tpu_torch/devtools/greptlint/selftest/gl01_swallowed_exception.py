"""Seeded GL01 violation: except Exception that does nothing at all."""


def load_optional_state(path):
    state = {}
    try:
        with open(path) as f:
            state = eval(f.read())  # noqa: S307 — fixture only, never run
    except Exception:
        pass
    return state
