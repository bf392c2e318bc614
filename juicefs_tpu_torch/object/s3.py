"""AWS Signature Version 4 for the S3 service (a copy of the signer in
juicefs_tpu/object/s3.py; reference pkg/object/s3.go).

The port's S3 gateway verifies signed requests with `SigV4.verify`, and a
client (the tests, `chip_smoke.py`) signs them with `SigV4.sign`. The S3
object-storage driver (`S3Storage`) and the `s3://` scheme of
`create_storage` are not ported yet: this module holds only the signer.
"""

from __future__ import annotations

import datetime
import hashlib
import hmac
import urllib.parse
from typing import Optional

_EMPTY_SHA256 = hashlib.sha256(b"").hexdigest()


def _uri_escape(s: str, keep_slash: bool) -> str:
    safe = "/-_.~" if keep_slash else "-_.~"
    return urllib.parse.quote(s, safe=safe)


class SigV4:
    """AWS Signature Version 4 for the S3 service (sign + server verify)."""

    def __init__(self, access_key: str, secret_key: str, region: str = "us-east-1"):
        self.ak, self.sk, self.region = access_key, secret_key, region

    def _signature(
        self,
        method: str,
        path: str,
        query: dict[str, str],
        headers: dict[str, str],
        signed_list: list[str],
        amz_date: str,
    ) -> str:
        datestamp = amz_date[:8]
        canonical_query = "&".join(
            f"{_uri_escape(k, False)}={_uri_escape(v, False)}"
            for k, v in sorted(query.items())
        )
        canonical = "\n".join([
            method,
            _uri_escape(path, True),
            canonical_query,
            "".join(f"{k}:{headers.get(k, '').strip()}\n" for k in signed_list),
            ";".join(signed_list),
            headers.get("x-amz-content-sha256", _EMPTY_SHA256),
        ])
        scope = f"{datestamp}/{self.region}/s3/aws4_request"
        sts = "\n".join([
            "AWS4-HMAC-SHA256",
            amz_date,
            scope,
            hashlib.sha256(canonical.encode()).hexdigest(),
        ])
        key = f"AWS4{self.sk}".encode()
        for part in (datestamp, self.region, "s3", "aws4_request"):
            key = hmac.new(key, part.encode(), hashlib.sha256).digest()
        return hmac.new(key, sts.encode(), hashlib.sha256).hexdigest()

    def sign(
        self,
        method: str,
        host: str,
        path: str,
        query: dict[str, str],
        payload_hash: str,
        extra_headers: Optional[dict[str, str]] = None,
        now: Optional[datetime.datetime] = None,
    ) -> dict[str, str]:
        now = now or datetime.datetime.now(datetime.timezone.utc)
        amz_date = now.strftime("%Y%m%dT%H%M%SZ")
        headers = {
            "host": host,
            "x-amz-content-sha256": payload_hash,
            "x-amz-date": amz_date,
        }
        # all x-amz-* request headers must be signed (AWS requirement)
        for k, v in (extra_headers or {}).items():
            if k.lower().startswith("x-amz-"):
                headers[k.lower()] = v
        signed_list = sorted(headers)
        sig = self._signature(method, path, query, headers, signed_list, amz_date)
        scope = f"{amz_date[:8]}/{self.region}/s3/aws4_request"
        headers["Authorization"] = (
            f"AWS4-HMAC-SHA256 Credential={self.ak}/{scope}, "
            f"SignedHeaders={';'.join(signed_list)}, Signature={sig}"
        )
        del headers["host"]  # http.client sets it; it is still signed
        return headers

    def verify(
        self,
        method: str,
        path: str,
        query: dict[str, str],
        headers: dict[str, str],
        authorization: str,
    ) -> bool:
        """Server-side check: recompute the signature from the raw request.

        `headers` must be lowercase-keyed and include host/x-amz-date/
        x-amz-content-sha256 as received on the wire.
        """
        try:
            parts = dict(
                p.strip().split("=", 1)
                for p in authorization.split(" ", 1)[1].split(",")
            )
            cred = parts["Credential"].split("/")
            signed_list = parts["SignedHeaders"].split(";")
            sig = parts["Signature"]
        except (KeyError, IndexError, ValueError):
            return False
        if cred[0] != self.ak:
            return False
        amz_date = headers.get("x-amz-date", "")
        if not amz_date:
            return False
        want = self._signature(method, path, query, headers, signed_list, amz_date)
        return hmac.compare_digest(want, sig)
