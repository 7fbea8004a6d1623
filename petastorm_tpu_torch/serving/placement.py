"""PartitionMap: consistent-hash placement for the lookup fleet
(counterpart of ``petastorm_tpu/serving/placement.py``; the ring, the
assignments and the wire and JSON bytes are the JAX package's, so both
packages' servers and clients compute and exchange one map).

The lookup tier's key space is split into ``n_partitions`` hash
partitions; each partition is owned by ``replication`` servers ranked
primary-first. Placement is a **pure function of the membership set** —
a consistent-hash ring of member vnodes, walked clockwise from each
partition's own ring point — so every server (and every client) that
knows the same members computes the *identical* map without any
coordinator. Membership changes go through :func:`add_member` /
:func:`remove_member`, which recompute the ring and bump ``version``;
the consistent-hash property keeps most partition->replica assignments
stable across a single join or drain, which is what bounds the cache
warm-up a reassignment costs.

Maps travel as JSON (:meth:`PartitionMap.to_wire` /
:meth:`PartitionMap.from_wire`) inside the servers' lease-heartbeat PUB
stream and the ``pmap`` / ``pmap_update`` rpc verbs; clients and peers
converge on the highest version they have seen.

Two granularities hang off one map:

* **keys** route by hash — :meth:`PartitionMap.partition_of_key` uses
  the same string form the row-level index stores, so a client can
  route without holding the index;
* **row-group pieces** partition modularly —
  :meth:`PartitionMap.pieces_of_partition` assigns piece ordinal ``i``
  to partition ``i % n_partitions``, giving predicate scatter a disjoint
  exact cover of the dataset.
"""

import bisect
import hashlib
import json

#: Ring points per member. More vnodes = smoother balance per member at
#: O(members * vnodes * log) build cost; 64 keeps a 2-server fleet
#: within a few percent of even.
DEFAULT_VNODES = 64

DEFAULT_PARTITIONS = 8


def _hash64(text):
    """Stable 64-bit ring position (md5-derived: identical across
    processes, platforms, and PYTHONHASHSEED)."""
    digest = hashlib.md5(text.encode('utf-8')).digest()
    return int.from_bytes(digest[:8], 'little')


def partition_of_key(value, n_partitions):
    """The hash partition serving key ``value`` — matched by the key's
    STRING form, same as :class:`~petastorm_tpu_torch.serving.row_index.
    RowLocationIndex` (so ``7`` and ``'7'`` route identically)."""
    return _hash64('key:{}'.format(value)) % int(n_partitions)


class PartitionMap(object):
    """One versioned placement: partitions -> ranked replica servers.

    :param version: monotonic map version; fleets converge on the max.
    :param n_partitions: hash-partition count (fixed for a map's life).
    :param replication: replica target R per partition (effective R is
        ``min(R, len(members))``).
    :param members: ``{server_name: {'rpc': endpoint,
        'control': endpoint-or-None}}``.
    :param assignments: ``{partition: (server_name, ...)}`` ranked
        primary-first.
    """

    def __init__(self, version, n_partitions, replication, members,
                 assignments):
        self.version = int(version)
        self.n_partitions = int(n_partitions)
        self.replication = int(replication)
        self.members = {str(name): dict(info)
                        for name, info in members.items()}
        self.assignments = {int(pid): tuple(names)
                            for pid, names in assignments.items()}

    # -- routing -----------------------------------------------------------

    def partition_of_key(self, value):
        return partition_of_key(value, self.n_partitions)

    def replicas(self, partition):
        """Server names owning ``partition``, primary first."""
        return list(self.assignments.get(int(partition), ()))

    def endpoints(self, partition):
        """The replicas' rpc endpoints, in replica-rank order."""
        out = []
        for name in self.replicas(partition):
            rpc = (self.members.get(name) or {}).get('rpc')
            if rpc and rpc not in out:
                out.append(rpc)
        return out

    def is_primary(self, name, partition):
        reps = self.assignments.get(int(partition), ())
        return bool(reps) and reps[0] == name

    def partitions_of(self, name):
        """Partitions ``name`` replicates, ascending."""
        return [pid for pid in sorted(self.assignments)
                if name in self.assignments[pid]]

    def pieces_of_partition(self, partition, n_pieces):
        """Row-group piece ordinals the modular cover assigns to
        ``partition`` — disjoint and exact over ``range(n_pieces)``."""
        return list(range(int(partition), int(n_pieces), self.n_partitions))

    # -- wire format -------------------------------------------------------

    def to_wire(self):
        """JSON-safe dict (heartbeat bodies, rpc replies)."""
        return {'version': self.version,
                'n_partitions': self.n_partitions,
                'replication': self.replication,
                'members': {name: dict(info)
                            for name, info in self.members.items()},
                'assignments': {str(pid): list(names)
                                for pid, names in self.assignments.items()}}

    @classmethod
    def from_wire(cls, wire):
        try:
            return cls(wire['version'], wire['n_partitions'],
                       wire['replication'], wire['members'],
                       wire['assignments'])
        except (TypeError, KeyError, ValueError) as e:
            raise ValueError('malformed partition map {!r}: {}'
                             .format(wire, e))

    def to_json(self):
        return json.dumps(self.to_wire(), sort_keys=True)

    def __eq__(self, other):
        return (isinstance(other, PartitionMap)
                and self.to_wire() == other.to_wire())

    def __ne__(self, other):
        return not self.__eq__(other)

    def __repr__(self):
        return ('PartitionMap(v{m.version}, {m.n_partitions}p x '
                'R{m.replication}, members={names})'.format(
                    m=self, names=sorted(self.members)))


def _ring(names, vnodes):
    points = []
    for name in names:
        for vnode in range(vnodes):
            points.append((_hash64('member:{}#{}'.format(name, vnode)),
                           name))
    points.sort()
    return points


def build_partition_map(members, n_partitions=DEFAULT_PARTITIONS,
                        replication=2, version=1, vnodes=DEFAULT_VNODES):
    """Compute placement from scratch: deterministic in ``members`` (any
    two parties holding the same membership derive byte-identical
    assignments). Each partition hashes onto the vnode ring and takes
    the next ``replication`` DISTINCT members clockwise, primary first.
    """
    names = sorted(str(n) for n in members)
    if not names:
        raise ValueError('a partition map needs at least one member')
    n_partitions = int(n_partitions)
    if n_partitions < 1:
        raise ValueError('n_partitions must be >= 1, got {}'
                         .format(n_partitions))
    effective_r = min(int(replication), len(names))
    if effective_r < 1:
        raise ValueError('replication must be >= 1, got {}'
                         .format(replication))
    points = _ring(names, vnodes)
    assignments = {}
    for pid in range(n_partitions):
        start = bisect.bisect_left(points,
                                   (_hash64('partition:{}'.format(pid)), ''))
        chosen = []
        for offset in range(len(points)):
            name = points[(start + offset) % len(points)][1]
            if name not in chosen:
                chosen.append(name)
                if len(chosen) == effective_r:
                    break
        assignments[pid] = tuple(chosen)
    return PartitionMap(version, n_partitions, replication,
                        {name: dict(members[name]) for name in members},
                        assignments)


def add_member(pmap, name, rpc, control=None):
    """A joining replica: recomputed placement over ``members + name``,
    ``version + 1``."""
    members = {n: dict(info) for n, info in pmap.members.items()}
    members[str(name)] = {'rpc': rpc, 'control': control}
    return build_partition_map(members, n_partitions=pmap.n_partitions,
                               replication=pmap.replication,
                               version=pmap.version + 1)


def remove_member(pmap, name):
    """A draining/dead replica: recomputed placement without ``name``,
    ``version + 1``. The last member cannot leave (an empty map routes
    nothing — keep the map and let lease expiry mark the corpse)."""
    members = {n: dict(info) for n, info in pmap.members.items()
               if n != str(name)}
    if not members:
        raise ValueError('cannot remove the last fleet member {!r}'
                         .format(name))
    return build_partition_map(members, n_partitions=pmap.n_partitions,
                               replication=pmap.replication,
                               version=pmap.version + 1)
