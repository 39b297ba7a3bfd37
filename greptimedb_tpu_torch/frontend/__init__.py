"""Frontend: the SQL/protocol-facing instance.

Reference behavior: src/frontend — implements the protocol handler traits
(src/frontend/src/instance.rs:83-97), auto table create/alter on insert
(instance.rs:292-342), and the statement executor
(src/frontend/src/statement.rs).
"""

from .instance import FrontendInstance, build_standalone

__all__ = ["FrontendInstance", "build_standalone"]
