"""The wire version of persisted documents (port of
ballista_tpu/serde/plans.py `WIRE_VERSION` and `check_wire_version`, what
`scheduler/job_store.py` reads). The logical-plan codec (`plan_to_json`,
`plan_from_json`) is not ported."""

from __future__ import annotations

WIRE_VERSION = 1


class WireVersionError(ValueError):
    pass


def check_wire_version(doc: dict, what: str = "document"):
    """Raise if `doc` was encoded under a different WIRE_VERSION.
    Documents without a tag predate versioning and are rejected too."""
    v = doc.get("@wire")
    if v != WIRE_VERSION:
        raise WireVersionError(
            f"{what} encoded under wire version {v!r}; this build reads "
            f"version {WIRE_VERSION} — re-submit the job (persisted state "
            "from other versions is not decodable)")
