"""Pluggable authentication.

Reference behavior: src/servers/src/auth/user_provider.rs:290 — a
`UserProvider` resolving username/password, configured either from a static
option (`user=pwd`) or a htpasswd-style file.
"""

from __future__ import annotations

import base64
import hmac
from typing import Dict, Optional

from ..errors import AuthError


class UserProvider:
    #: wire protocols ask the client for credentials only when true
    requires_password = True

    def authenticate(self, username: str, password: str) -> bool:
        raise NotImplementedError

    def plain_password(self, username: str) -> Optional[str]:
        """Plaintext lookup for challenge-response schemes
        (mysql_native_password / postgres md5); None = unknown user."""
        return None

    def auth_http_basic(self, header: Optional[str]) -> str:
        """Validate an Authorization: Basic header; returns the username."""
        if not header or not header.lower().startswith("basic "):
            raise AuthError("missing basic auth")
        try:
            raw = base64.b64decode(header.split(" ", 1)[1]).decode()
            username, _, password = raw.partition(":")
        except Exception as e:
            raise AuthError("malformed basic auth") from e
        if not self.authenticate(username, password):
            raise AuthError("bad username or password")
        return username


class StaticUserProvider(UserProvider):
    """static_user_provider=cmd:user=pwd / file:path (reference syntax)."""

    def __init__(self, users: Dict[str, str]):
        self.users = dict(users)

    @staticmethod
    def from_option(option: str) -> "StaticUserProvider":
        kind, _, rest = option.partition(":")
        users: Dict[str, str] = {}
        if kind == "cmd":
            for pair in rest.split(","):
                name, _, pwd = pair.partition("=")
                if not name or not pwd:
                    raise ValueError(f"bad user option {pair!r}")
                users[name] = pwd
        elif kind == "file":
            with open(rest) as f:
                for line in f:
                    line = line.strip()
                    if not line or line.startswith("#"):
                        continue
                    name, _, pwd = line.partition("=")
                    users[name] = pwd
        else:
            raise ValueError(f"unknown user provider kind {kind!r}")
        return StaticUserProvider(users)

    def authenticate(self, username: str, password: str) -> bool:
        expected = self.users.get(username)
        if expected is None:
            return False
        return hmac.compare_digest(expected.encode(), password.encode())

    def plain_password(self, username: str) -> Optional[str]:
        return self.users.get(username)


class NoopUserProvider(UserProvider):
    requires_password = False

    def authenticate(self, username: str, password: str) -> bool:
        return True

    def auth_http_basic(self, header: Optional[str]) -> str:
        return "greptime"
