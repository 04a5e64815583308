"""Per-job HMAC signing of the runner's function channel (a copy of
``horovod_tpu/runner/secret.py``: the same wire format, so a blob
signed by either package verifies in the other).

Parity surface: ``horovod/runner/common/util/secret.py`` — the
reference generates a per-job secret and signs every driver/task
service message so a pickled payload is only loaded if its HMAC
verifies.  Here the signed artifacts are the two pickle files of the
programmatic ``run()`` API: the shipped function blob and each rank's
result blob — both cross a filesystem (and, on the ssh path, a remote
host), and unpickling unverified bytes is arbitrary code execution.

Wire format: ``HMAC_SHA256(key, blob) || blob`` (32-byte digest
prefix).  The key travels to workers in ``HVTPU_SECRET_KEY`` (parity:
the reference passes its secret through the env of spawned workers).
"""

from __future__ import annotations

import hmac
import os
import secrets as _secrets

ENV_KEY = "HVTPU_SECRET_KEY"
# Path-indirection variant: the env carries only the PATH of a 0600
# key file, never the key itself — ssh serializes the worker env into
# its argv, and argv is world-readable via /proc/*/cmdline, which
# would hand every local user the forging key.  run() uses the file
# form; ENV_KEY remains for single-machine/manual invocations.
ENV_KEY_FILE = "HVTPU_SECRET_FILE"
DIGEST_BYTES = 32


class SignatureError(RuntimeError):
    """A signed blob failed verification — fail closed, never unpickle."""


def make_secret_key() -> str:
    return _secrets.token_hex(32)


def _key_bytes(key: str) -> bytes:
    return key.encode("ascii")


def sign(key: str, blob: bytes) -> bytes:
    """``digest || blob`` ready to write."""
    digest = hmac.new(_key_bytes(key), blob, "sha256").digest()
    return digest + blob


def verify(key: str, signed: bytes) -> bytes:
    """Return the payload iff the digest checks out; raise otherwise."""
    if len(signed) < DIGEST_BYTES:
        raise SignatureError("signed blob shorter than its digest")
    digest, blob = signed[:DIGEST_BYTES], signed[DIGEST_BYTES:]
    want = hmac.new(_key_bytes(key), blob, "sha256").digest()
    if not hmac.compare_digest(digest, want):
        raise SignatureError(
            "HMAC signature mismatch on runner payload; refusing to "
            "unpickle (tampered or foreign file)"
        )
    return blob


def write_key_file(key: str, path: str) -> None:
    fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_EXCL, 0o600)
    with os.fdopen(fd, "w") as f:
        f.write(key)


def require_env_key() -> str:
    path = os.environ.get(ENV_KEY_FILE, "")
    if path:
        try:
            with open(path) as f:
                return f.read().strip()
        except OSError as e:
            raise SignatureError(
                f"cannot read {ENV_KEY_FILE}={path!r}: {e}"
            ) from None
    key = os.environ.get(ENV_KEY, "")
    if not key:
        raise SignatureError(
            f"neither {ENV_KEY_FILE} nor {ENV_KEY} is set; the "
            "runner's function channel is signed per job and workers "
            "refuse unsigned payloads"
        )
    return key
