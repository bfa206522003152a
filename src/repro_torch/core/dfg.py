"""Feed-forward data-flow-graph IR — the overlay's compile target.

The paper's overlay executes *feed-forward DFGs* (Section III): nodes are
arithmetic operations, edges carry 32-bit values, primary inputs stream in
from a FIFO and primary outputs stream out.  This module is the IR that the
frontend produces and the scheduler consumes.

Conventions (used to reproduce Table II):
  * ``op nodes``    — arithmetic nodes only (not i/o nodes, not constants).
  * ``graph depth`` — max ASAP level over op nodes (inputs are level 0);
                      equals the number of FUs in the linear overlay.
  * ``edges``       — non-constant operand references plus one edge per
                      primary output (op -> o-node).
  * ``average parallelism`` — op_nodes / depth.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Iterable, Mapping, Sequence


class Op(enum.IntEnum):
    """Overlay opcode set (DSP48E1-expressible ops, paper Section III-A).

    The DSP48E1 ALU supports add/sub/mul (and logic ops) selected by
    configuration bits; const variants fold one immediate operand, matching
    the paper's 32-bit no-decoder instruction word.
    """

    BYP = 0    # data bypass (forward operand A to the next stage)
    ADD = 1    # a + b
    SUB = 2    # a - b
    MUL = 3    # a * b
    ADDC = 4   # a + imm
    SUBC = 5   # a - imm
    RSUBC = 6  # imm - a
    MULC = 7   # a * imm
    SQR = 8    # a * a (encoded as MUL with both operands = A)
    MAX = 9    # max(a, b)
    MIN = 10   # min(a, b)
    ABS = 11   # |a|
    NEG = 12   # -a
    AND = 13   # bitwise/logical and (integer datapath)
    OR = 14
    XOR = 15
    OUT = 16   # stream result to the output FIFO (scheduler-inserted)
    NOP = 17


#: ops that reference two distinct value operands
BINARY_OPS = frozenset({Op.ADD, Op.SUB, Op.MUL, Op.MAX, Op.MIN,
                        Op.AND, Op.OR, Op.XOR})
#: ops with one value operand + one immediate
CONST_OPS = frozenset({Op.ADDC, Op.SUBC, Op.RSUBC, Op.MULC})
#: unary ops with a single value operand reference
UNARY_OPS = frozenset({Op.ABS, Op.NEG, Op.BYP})
#: SQR references its single operand twice (a * a) — counts as 2 edges,
#: matching the paper's Fig. 1(b) 'SQR (R0 R0)' two-register encoding.
SELF_OPS = frozenset({Op.SQR})


@dataclasses.dataclass(frozen=True)
class Node:
    """One DFG node.

    ``args`` are names of producer nodes (inputs or other ops).  ``imm`` is
    the folded immediate for ``CONST_OPS``.
    """

    name: str
    op: Op
    args: tuple[str, ...] = ()
    imm: float | int | None = None

    def value_refs(self) -> tuple[str, ...]:
        """Operand references that carry values (for edge counting)."""
        if self.op in SELF_OPS:
            return (self.args[0], self.args[0])
        return self.args


class DFGError(ValueError):
    pass


@dataclasses.dataclass
class DFG:
    """A feed-forward DFG: primary inputs, op nodes, primary outputs."""

    name: str
    inputs: tuple[str, ...]
    nodes: dict[str, Node]
    outputs: tuple[str, ...]

    # ------------------------------------------------------------------ build
    @classmethod
    def build(cls, name: str, inputs: Sequence[str],
              nodes: Iterable[Node], outputs: Sequence[str]) -> "DFG":
        node_map: dict[str, Node] = {}
        for n in nodes:
            if n.name in node_map or n.name in inputs:
                raise DFGError(f"duplicate node name {n.name!r}")
            node_map[n.name] = n
        g = cls(name=name, inputs=tuple(inputs), nodes=node_map,
                outputs=tuple(outputs))
        g.validate()
        return g

    # --------------------------------------------------------------- validate
    def validate(self) -> None:
        defined = set(self.inputs)
        order = self.topo_order()
        for nname in order:
            node = self.nodes[nname]
            for a in node.args:
                if a not in defined:
                    raise DFGError(
                        f"{self.name}: node {nname!r} uses undefined {a!r}")
            defined.add(nname)
        for o in self.outputs:
            if o not in self.nodes:
                raise DFGError(f"{self.name}: output {o!r} is not an op node")
        # dead code is illegal: the linear pipeline streams every FU result
        # forward, so an unconsumed non-output value has no legal slot.
        consumed: set[str] = set(self.outputs)
        for node in self.nodes.values():
            consumed.update(node.args)
        for n in self.nodes:
            if n not in consumed:
                raise DFGError(f"{self.name}: dead node {n!r}")
        for i in self.inputs:
            if i not in consumed:
                raise DFGError(f"{self.name}: unused input {i!r}")
        arity = {**{op: 2 for op in BINARY_OPS},
                 **{op: 1 for op in CONST_OPS | UNARY_OPS | SELF_OPS}}
        for node in self.nodes.values():
            want = arity.get(node.op)
            if want is not None and len(node.args) != want:
                raise DFGError(
                    f"{self.name}: {node.name} op {node.op.name} wants "
                    f"{want} args, got {len(node.args)}")
            if node.op in CONST_OPS and node.imm is None:
                raise DFGError(f"{self.name}: {node.name} missing imm")

    # ------------------------------------------------------------------- topo
    def topo_order(self) -> list[str]:
        """Deterministic topological order (Kahn, insertion-stable)."""
        indeg = {n: 0 for n in self.nodes}
        consumers: dict[str, list[str]] = {n: [] for n in self.nodes}
        for n, node in self.nodes.items():
            for a in node.args:
                if a in self.nodes:
                    indeg[n] += 1
                    consumers[a].append(n)
        ready = [n for n in self.nodes if indeg[n] == 0]
        out: list[str] = []
        while ready:
            n = ready.pop(0)
            out.append(n)
            for c in consumers[n]:
                indeg[c] -= 1
                if indeg[c] == 0:
                    ready.append(c)
        if len(out) != len(self.nodes):
            raise DFGError(f"{self.name}: cycle detected (not feed-forward)")
        return out

    # ------------------------------------------------------------------ levels
    def asap_levels(self) -> dict[str, int]:
        """ASAP level per node; primary inputs are level 0."""
        level: dict[str, int] = {i: 0 for i in self.inputs}
        for n in self.topo_order():
            node = self.nodes[n]
            lv = 0
            for a in node.args:
                lv = max(lv, level[a])
            level[n] = lv + 1
        return level

    # ------------------------------------------------------------------- stats
    @property
    def n_ops(self) -> int:
        return len(self.nodes)

    @property
    def depth(self) -> int:
        lv = self.asap_levels()
        return max((lv[n] for n in self.nodes), default=0)

    @property
    def n_edges(self) -> int:
        refs = sum(len(n.value_refs()) for n in self.nodes.values())
        return refs + len(self.outputs)

    def stats(self) -> dict[str, float]:
        """Table II columns derivable from the graph alone."""
        d = self.depth
        return {
            "io_nodes": (len(self.inputs), len(self.outputs)),
            "graph_edges": self.n_edges,
            "op_nodes": self.n_ops,
            "graph_depth": d,
            "average_parallelism": round(self.n_ops / d, 2) if d else 0.0,
        }

    def consumers_by_level(self) -> dict[str, list[int]]:
        """For each value (input or op), the ASAP levels that consume it."""
        lv = self.asap_levels()
        uses: dict[str, list[int]] = {}
        for n in self.topo_order():
            node = self.nodes[n]
            for a in set(node.args):
                uses.setdefault(a, []).append(lv[n])
        return uses
