"""TLS configuration for protocol servers.

Reference behavior: src/servers/src/tls.rs:240 — `TlsOption` with modes
disable | prefer | require, certificate + key paths, building the
server-side TLS config consumed by the MySQL and Postgres listeners
(both of which upgrade mid-handshake: MySQL via the SSLRequest
capability, Postgres via the SSLRequest startup message).
"""

from __future__ import annotations

import ssl
from dataclasses import dataclass
from typing import Optional


@dataclass
class TlsOption:
    mode: str = "disable"             # disable | prefer | require
    cert_path: Optional[str] = None
    key_path: Optional[str] = None

    def setup(self) -> Optional[ssl.SSLContext]:
        """Build the server SSLContext, or None when disabled."""
        if self.mode == "disable":
            return None
        if not self.cert_path or not self.key_path:
            raise ValueError(
                f"tls mode {self.mode!r} needs cert_path and key_path")
        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
        ctx.load_cert_chain(self.cert_path, self.key_path)
        return ctx

    @staticmethod
    def from_config(doc: dict) -> "TlsOption":
        return TlsOption(mode=doc.get("mode", "disable"),
                         cert_path=doc.get("cert_path"),
                         key_path=doc.get("key_path"))


def make_self_signed(cert_path: str, key_path: str,
                     common_name: str = "greptimedb-tpu") -> None:
    """Generate a self-signed certificate (tests / dev bootstrap)."""
    import datetime

    from cryptography import x509
    from cryptography.hazmat.primitives import hashes, serialization
    from cryptography.hazmat.primitives.asymmetric import rsa
    from cryptography.x509.oid import NameOID

    key = rsa.generate_private_key(public_exponent=65537, key_size=2048)
    name = x509.Name([x509.NameAttribute(NameOID.COMMON_NAME, common_name)])
    now = datetime.datetime.now(datetime.timezone.utc)
    cert = (x509.CertificateBuilder()
            .subject_name(name).issuer_name(name)
            .public_key(key.public_key())
            .serial_number(x509.random_serial_number())
            .not_valid_before(now - datetime.timedelta(minutes=5))
            .not_valid_after(now + datetime.timedelta(days=365))
            .add_extension(x509.SubjectAlternativeName(
                [x509.DNSName("localhost")]), critical=False)
            .sign(key, hashes.SHA256()))
    with open(key_path, "wb") as f:
        f.write(key.private_bytes(
            serialization.Encoding.PEM,
            serialization.PrivateFormat.TraditionalOpenSSL,
            serialization.NoEncryption()))
    with open(cert_path, "wb") as f:
        f.write(cert.public_bytes(serialization.Encoding.PEM))
