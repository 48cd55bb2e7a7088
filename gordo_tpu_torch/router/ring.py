"""
Consistent hashing of machine names onto replica ids (the port of
``gordo_tpu.router.ring``).

A ring rather than ``hash(name) % N``: when a replica joins or leaves,
only about 1/N of the machines move, so the other replicas keep the
weights they hold resident. Points are the first 8 bytes of md5, stable
across processes and platforms, so the router and every replica compute
the same owner of every machine from the same ``(replicas, vnodes)``
shard manifest: the manifest is the shard map. Owners equal the JAX
package's exactly.
"""

import bisect
import hashlib
from typing import Dict, Iterable, List, Sequence, Set, Tuple

#: virtual nodes a replica
DEFAULT_VNODES = 64


def _hash64(value: str) -> int:
    """The first 8 bytes of md5 as an int: the ring's point space."""
    return int.from_bytes(hashlib.md5(value.encode("utf-8")).digest()[:8], "big")


class HashRing:
    """An immutable ring over replica ids: each replica owns ``vnodes``
    points at ``md5("<replica>#<i>")``, and a machine belongs to the first
    replica point after its own (wrapping). A membership change builds a
    new ring, so a request in flight keeps the ring it started with."""

    def __init__(self, replicas: Sequence[str], vnodes: int = DEFAULT_VNODES):
        if not replicas:
            raise ValueError("HashRing needs at least one replica id")
        if len(set(replicas)) != len(replicas):
            raise ValueError(f"Duplicate replica ids: {sorted(replicas)}")
        if vnodes < 1:
            raise ValueError(f"vnodes must be >= 1, got {vnodes}")
        self.replicas: Tuple[str, ...] = tuple(sorted(replicas))
        self.vnodes = int(vnodes)
        points = sorted((_hash64(f"{replica}#{i}"), replica)
                        for replica in self.replicas for i in range(self.vnodes))
        self._points = [p for p, _ in points]
        self._owners = [r for _, r in points]

    def owner(self, machine_name: str) -> str:
        """The replica owning ``machine_name``."""
        index = bisect.bisect_right(self._points, _hash64(machine_name))
        return self._owners[index % len(self._owners)]

    def preference(self, machine_name: str) -> List[str]:
        """Every replica in ring order from the machine's point: the owner
        first, then its failover successors, each once."""
        start = bisect.bisect_right(self._points, _hash64(machine_name))
        ordered: List[str] = []
        seen: Set[str] = set()
        n = len(self._owners)
        for step in range(n):
            replica = self._owners[(start + step) % n]
            if replica not in seen:
                seen.add(replica)
                ordered.append(replica)
                if len(ordered) == len(self.replicas):
                    break
        return ordered

    def shard(self, machine_names: Iterable[str], replica: str) -> Set[str]:
        """The machines of ``machine_names`` that ``replica`` owns."""
        return {m for m in machine_names if self.owner(m) == replica}

    def partition(self, machine_names: Iterable[str]) -> Dict[str, List[str]]:
        """Owner -> its machines, sorted; only replicas that own some."""
        shards: Dict[str, List[str]] = {}
        for name in machine_names:
            shards.setdefault(self.owner(name), []).append(name)
        return {r: sorted(ms) for r, ms in shards.items()}
