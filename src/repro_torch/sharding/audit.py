"""Cross-rank communication audit of the sharded serving path — the
counterpart of ``repro/sharding/audit.py`` (``collective_footprint``,
``max_loop_collective_elems``).

The hierarchical round promises that no (M, ...) array crosses ranks inside
a serving round, only O(ranks) scalars.  The reference measures that on the
jaxpr; here the collectives record every exchange they make
(``collectives.COLLECTIVES``) and the audit reads what a call really
exchanged: measured, not hoped.  This module is the one reader of that
record.
"""
from __future__ import annotations

from repro_torch.sharding.collectives import COLLECTIVES


def collective_footprint(fn, *args, **kwargs) -> list:
    """Run ``fn(*args, **kwargs)`` and return the collectives it made, a
    list of ``(op, elements, inside_round)``."""
    start = len(COLLECTIVES)
    fn(*args, **kwargs)
    return list(COLLECTIVES[start:])


def round_records(records) -> list:
    """The ``(op, elements)`` of the records made inside a serving round."""
    return [(op, n) for op, n, inside in records if inside]


def round_footprint(records, rounds: int) -> dict:
    """What a run of ``rounds`` rounds exchanged: collectives and elements
    a round, the largest in-round operand (the reference's
    ``max_loop_collective_elems``; 0 when the rounds exchanged nothing),
    and the collectives and elements outside the rounds."""
    inside = [n for _, n in round_records(records)]
    outside = [n for _, n, flag in records if not flag]
    return {"collectives_per_round": len(inside) / rounds,
            "elements_per_round": sum(inside) / rounds,
            "max_elements": max(inside, default=0),
            "outside_rounds": len(outside),
            "elements_outside_rounds": sum(outside)}
