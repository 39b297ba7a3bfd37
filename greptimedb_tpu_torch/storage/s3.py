"""S3-compatible object store backend (stdlib SigV4 client).

Reference behavior: src/object-store — opendal's S3 service configured
with bucket/root/endpoint/credentials (src/datanode/src/instance.rs:
object store construction) gives the storage engine an S3 data home.
Here the same `ObjectStore` surface speaks the S3 REST API directly:
AWS Signature V4, path-style addressing (works against AWS, MinIO, GCS
interop, and the in-process mock used by tests).

Ported from greptimedb_tpu/storage/s3.py unchanged: the same requests,
signatures, error taxonomy and `objstore_request` failpoint.
"""

from __future__ import annotations

import datetime
import hashlib
import hmac
import http.client
import urllib.parse
import xml.etree.ElementTree as ET
from dataclasses import dataclass
from typing import List, Optional, Tuple

from ..common.failpoint import register as _fp_register
from ..errors import GreptimeError
from .object_store import ObjectStore

_fp_register("objstore_request")


@dataclass
class S3Config:
    bucket: str
    root: str = ""                    # key prefix inside the bucket
    endpoint: Optional[str] = None    # http://host:port for non-AWS
    region: str = "us-east-1"
    access_key_id: str = ""
    secret_access_key: str = ""


class S3Error(GreptimeError):
    """Terminal S3 failure (4xx, signature mismatch, malformed reply)."""


class S3TransientError(S3Error):
    """Retryable S3 failure: HTTP 5xx/429 (service hiccup, throttling)
    or a socket-level error before a status line arrived. The
    RetryingObjectStore wrapper backs off and retries these; plain
    S3Error surfaces immediately."""


#: statuses worth retrying: server errors + explicit throttling
_TRANSIENT_STATUSES = frozenset({429, 500, 502, 503, 504, 509})


def _status_error(op: str, key: str, status: int, body: bytes = b"") -> S3Error:
    detail = f"S3 {op} {key}: HTTP {status}"
    if body:
        detail += f" {body[:200]!r}"
    if status in _TRANSIENT_STATUSES:
        return S3TransientError(detail)
    return S3Error(detail)


def _sha256(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def _hmac(key: bytes, msg: str) -> bytes:
    return hmac.new(key, msg.encode(), hashlib.sha256).digest()


class S3ObjectStore(ObjectStore):
    """ObjectStore over the S3 REST API."""

    def __init__(self, config: S3Config):
        self.config = config
        if config.endpoint:
            parsed = urllib.parse.urlparse(config.endpoint)
            self._host = parsed.netloc
            self._secure = parsed.scheme == "https"
        else:
            self._host = f"s3.{config.region}.amazonaws.com"
            self._secure = True
        self._root = config.root.strip("/")

    # ---- SigV4 ----
    def _sign(self, method: str, path: str, query: str,
              payload_hash: str, now: datetime.datetime) -> dict:
        cfg = self.config
        amz_date = now.strftime("%Y%m%dT%H%M%SZ")
        datestamp = now.strftime("%Y%m%d")
        headers = {
            "host": self._host,
            "x-amz-content-sha256": payload_hash,
            "x-amz-date": amz_date,
        }
        signed_headers = ";".join(sorted(headers))
        canonical_headers = "".join(
            f"{k}:{headers[k]}\n" for k in sorted(headers))
        canonical_request = "\n".join([
            method, path, query, canonical_headers, signed_headers,
            payload_hash])
        scope = f"{datestamp}/{cfg.region}/s3/aws4_request"
        string_to_sign = "\n".join([
            "AWS4-HMAC-SHA256", amz_date, scope,
            _sha256(canonical_request.encode())])
        k = _hmac(b"AWS4" + cfg.secret_access_key.encode(), datestamp)
        k = _hmac(k, cfg.region)
        k = _hmac(k, "s3")
        k = _hmac(k, "aws4_request")
        signature = hmac.new(k, string_to_sign.encode(),
                             hashlib.sha256).hexdigest()
        headers["authorization"] = (
            f"AWS4-HMAC-SHA256 Credential={cfg.access_key_id}/{scope}, "
            f"SignedHeaders={signed_headers}, Signature={signature}")
        return headers

    def _request(self, method: str, key: str = "", query: str = "",
                 body: bytes = b"") -> Tuple[int, dict, bytes]:
        from ..common.failpoint import fail_point
        fail_point("objstore_request")
        path = "/" + urllib.parse.quote(self.config.bucket)
        if key:
            path += "/" + urllib.parse.quote(key, safe="/")
        payload_hash = _sha256(body)
        now = datetime.datetime.now(datetime.timezone.utc)
        headers = self._sign(method, path, query, payload_hash, now)
        conn_cls = http.client.HTTPSConnection if self._secure \
            else http.client.HTTPConnection
        conn = conn_cls(self._host, timeout=30)
        try:
            url = path + ("?" + query if query else "")
            conn.request(method, url, body=body, headers=headers)
            resp = conn.getresponse()
            data = resp.read()
            return resp.status, dict(resp.getheaders()), data
        except (OSError, http.client.HTTPException) as e:
            # no S3 status line arrived: connection refused/reset, DNS
            # hiccup, short read — all worth a retry, none a 4xx
            raise S3TransientError(
                f"S3 {method} {key or path}: {e}") from e
        finally:
            conn.close()

    # ---- ObjectStore surface ----
    def _key(self, key: str) -> str:
        return f"{self._root}/{key}" if self._root else key

    def read(self, key: str) -> bytes:
        status, _, data = self._request("GET", self._key(key))
        if status == 404:
            raise FileNotFoundError(key)
        if status != 200:
            raise _status_error("GET", key, status)
        return data

    def write(self, key: str, data: bytes) -> None:
        status, _, body = self._request("PUT", self._key(key), body=data)
        if status not in (200, 201):
            raise _status_error("PUT", key, status, body)

    def delete(self, key: str) -> None:
        status, _, _ = self._request("DELETE", self._key(key))
        if status not in (200, 204, 404):
            raise _status_error("DELETE", key, status)

    def delete_dir(self, key: str) -> None:
        prefix = key if key.endswith("/") else key + "/"
        for k in self.list(prefix):
            self.delete(k)

    def exists(self, key: str) -> bool:
        status, _, _ = self._request("HEAD", self._key(key))
        if status == 200:
            return True
        if status in (404, 403):
            return False
        raise _status_error("HEAD", key, status)

    def list(self, prefix: str) -> List[str]:
        full_prefix = self._key(prefix) if prefix else self._root
        out: List[str] = []
        token: Optional[str] = None
        while True:
            q = {"list-type": "2", "prefix": full_prefix}
            if token:
                q["continuation-token"] = token
            query = urllib.parse.urlencode(sorted(q.items()))
            status, _, data = self._request("GET", "", query=query)
            if status != 200:
                raise _status_error("LIST", prefix, status)
            root = ET.fromstring(data)
            ns = ""
            if root.tag.startswith("{"):
                ns = root.tag[:root.tag.index("}") + 1]
            for contents in root.iter(f"{ns}Contents"):
                k = contents.find(f"{ns}Key").text
                if self._root and k.startswith(self._root + "/"):
                    k = k[len(self._root) + 1:]
                out.append(k)
            truncated = root.find(f"{ns}IsTruncated")
            if truncated is not None and truncated.text == "true":
                tok = root.find(f"{ns}NextContinuationToken")
                token = tok.text if tok is not None else None
                if token is None:
                    break
            else:
                break
        return sorted(out)

    def local_path(self, key: str) -> Optional[str]:
        return None                      # remote; wrap in LruCacheLayer
