"""The coordination client of the port: the JAX coordination service's
key-value method names over a ``torch.distributed`` store.

``core/retry.py`` (``ResilientKV``, ``FencedKV``), the stall inspectors
(``comm/stall.py``) and the wire consensus (``comm/wirefault.py``) keep
the reference's code, which calls ``key_value_set``,
``key_value_try_get``, ``blocking_key_value_get``, ``key_value_delete``
and ``key_value_dir_get`` on ``jax.distributed``'s client.
:class:`StoreKV` gives a store those five methods; ``init()`` builds one
on the default group's store, under the prefix ``hvt_kv``.

Values are text (the protocols exchange JSON).  Each method is one or
two store round trips and none of them blocks inside the store:

- ``key_value_try_get`` is one ``compare_set(key, ABSENT, ABSENT)``,
  which returns the value when the key exists and ``ABSENT`` (a value no
  protocol writes) when it does not, and never writes; a store's ``get``
  would wait out the store's timeout on a missing key.  A missing key
  raises ``KeyError`` carrying ``NOT_FOUND``, as the JAX client's error
  does.
- ``blocking_key_value_get`` polls it with a backoff from 0.2 ms up to
  ``poll_s`` until its deadline, then raises ``TimeoutError`` carrying
  ``DEADLINE_EXCEEDED``.
- ``key_value_dir_get`` needs no ``list_keys``: the ranks are known.
  Under a flat prefix (strict-mode marks ``hvtstall/<gen>/<set>/<seq>/``,
  votes ``hvtwire/.../<attempt>/``) the entries are ``<prefix><rank>``,
  one probe a rank.  Under a stream prefix (the heartbeats,
  ``hvtstallhb/<gen>/``, keys ``<prefix><rank>/<beat>``) every write
  also updates the pointer ``<prefix><rank>/newest`` to its beat, and the
  directory get reads each rank's pointer and then that beat: the
  newest entry a rank, which is the one the readers use.
- ``key_value_set`` overwrites (the JAX service refuses an existing
  key, which the reference's vote post works around; here the first
  attempt succeeds).
"""

from __future__ import annotations

import time
from typing import List, Sequence, Tuple, Union

#: What ``compare_set`` returns for a missing key; no protocol writes it.
ABSENT = b"\x00hvt-absent\x00"

#: Prefixes whose keys are ``<ns><gen>/<rank>/<n>``, read newest-first.
STREAM_NAMESPACES = ("hvtstallhb/",)
POINTER = "newest"


class StoreKV:
    """The coordination client over ``store`` for the ranks ``ranks``
    (a world size or the list of ranks)."""

    def __init__(self, store, ranks: Union[int, Sequence[int]],
                 poll_s: float = 0.05):
        self._store = store
        self.ranks: List[int] = (list(range(ranks))
                                 if isinstance(ranks, int) else list(ranks))
        self.poll_s = poll_s

    @staticmethod
    def _stream(key: str) -> bool:
        return key.startswith(STREAM_NAMESPACES)

    def key_value_set(self, key: str, value: str) -> None:
        self._store.set(key, value)
        if self._stream(key):
            parent, _, leaf = key.rpartition("/")
            if leaf != POINTER:
                self._store.set(f"{parent}/{POINTER}", leaf)

    def key_value_try_get(self, key: str) -> str:
        got = self._store.compare_set(key, ABSENT, ABSENT)
        if got == ABSENT:
            raise KeyError(f"NOT_FOUND: {key}")
        return bytes(got).decode()

    def blocking_key_value_get(self, key: str, timeout_ms: int) -> str:
        deadline = time.monotonic() + timeout_ms / 1000.0
        sleep = 0.0
        while True:
            try:
                return self.key_value_try_get(key)
            except KeyError:
                pass
            if time.monotonic() >= deadline:
                raise TimeoutError(
                    f"DEADLINE_EXCEEDED: {key} not posted within "
                    f"{timeout_ms} ms")
            sleep = min(self.poll_s, sleep * 2 if sleep else 2e-4)
            time.sleep(sleep)

    def key_value_delete(self, key: str) -> None:
        self._store.delete_key(key)

    def _get_or_none(self, key: str):
        try:
            return self.key_value_try_get(key)
        except KeyError:
            return None

    def key_value_dir_get(self, prefix: str) -> List[Tuple[str, str]]:
        out = []
        for r in self.ranks:
            if self._stream(prefix):
                leaf = self._get_or_none(f"{prefix}{r}/{POINTER}")
                if leaf is None:
                    continue
                key = f"{prefix}{r}/{leaf}"
            else:
                key = f"{prefix}{r}"
            value = self._get_or_none(key)
            if value is not None:
                out.append((key, value))
        return out
