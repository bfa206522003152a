"""HLL -> DFG conversion (paper Section IV, 'HLL to DFG Conversion').

The paper's in-house flow converts a C compute-kernel description into a DFG
text description.  We accept the equivalent: a small C-like/Python-like
kernel body of assignments over the primary inputs, e.g.::

    build_dfg("gradient", inputs=["m1","m2","m3","m4","m5"], source='''
        d1 = m1 - m3
        d2 = m2 - m3
        d3 = m3 - m4
        d4 = m3 - m5
        s1 = d1 * d1
        s2 = d2 * d2
        s3 = d3 * d3
        s4 = d4 * d4
        a1 = s1 + s2
        a2 = s3 + s4
        out = a1 + a2
    ''', outputs=["out"])

Supported: + - * (binary), unary -, abs/min/max, constants folded into
const-op immediates (ADDC/SUBC/RSUBC/MULC), x*x recognised as SQR.
Common-subexpression reuse happens through named temporaries, exactly as in
the paper's DFG figures.
"""

from __future__ import annotations

import ast

from repro_torch.core.dfg import DFG, DFGError, Node, Op

_BINOPS = {ast.Add: Op.ADD, ast.Sub: Op.SUB, ast.Mult: Op.MUL}
_CALLS = {"abs": Op.ABS, "min": Op.MIN, "max": Op.MAX}


class _NodeEmitter:
    def __init__(self, inputs: list[str]):
        self.inputs = list(inputs)
        self.nodes: list[Node] = []
        self.names: set[str] = set(inputs)
        self._tmp = 0

    def fresh(self) -> str:
        self._tmp += 1
        return f"_t{self._tmp}"

    def emit(self, name: str | None, op: Op, args: tuple[str, ...],
             imm=None) -> str:
        name = name or self.fresh()
        if name in self.names:
            raise DFGError(f"single-assignment violated for {name!r}")
        self.nodes.append(Node(name=name, op=op, args=args, imm=imm))
        self.names.add(name)
        return name

    # Returns either a value name (str) or a python constant (int/float).
    def eval_expr(self, e: ast.expr, target: str | None = None):
        if isinstance(e, ast.Constant):
            return e.value
        if isinstance(e, ast.Name):
            if e.id not in self.names:
                raise DFGError(f"use of undefined name {e.id!r}")
            if target is not None:
                # alias: materialize as a bypass so SSA naming holds
                return self.emit(target, Op.BYP, (e.id,))
            return e.id
        if isinstance(e, ast.UnaryOp) and isinstance(e.op, ast.USub):
            v = self.eval_expr(e.operand)
            if isinstance(v, (int, float)):
                return -v
            return self.emit(target, Op.NEG, (v,))
        if isinstance(e, ast.Call) and isinstance(e.func, ast.Name):
            op = _CALLS.get(e.func.id)
            if op is None:
                raise DFGError(f"unsupported call {e.func.id!r}")
            args = [self.eval_expr(a) for a in e.args]
            if any(isinstance(a, (int, float)) for a in args):
                raise DFGError(f"{e.func.id} over constants unsupported")
            return self.emit(target, op, tuple(args))
        if isinstance(e, ast.BinOp):
            opty = type(e.op)
            if opty not in _BINOPS:
                raise DFGError(f"unsupported operator {opty.__name__}")
            lhs = self.eval_expr(e.left)
            rhs = self.eval_expr(e.right)
            lc = isinstance(lhs, (int, float))
            rc = isinstance(rhs, (int, float))
            if lc and rc:  # constant fold
                return {ast.Add: lhs + rhs, ast.Sub: lhs - rhs,
                        ast.Mult: lhs * rhs}[opty]
            if lc or rc:
                const = lhs if lc else rhs
                val = rhs if lc else lhs
                if opty is ast.Add:
                    return self.emit(target, Op.ADDC, (val,), imm=const)
                if opty is ast.Mult:
                    return self.emit(target, Op.MULC, (val,), imm=const)
                # Sub: val - const  or  const - val
                if rc:
                    return self.emit(target, Op.SUBC, (val,), imm=const)
                return self.emit(target, Op.RSUBC, (val,), imm=const)
            if lhs == rhs and opty is ast.Mult:
                return self.emit(target, Op.SQR, (lhs,))
            return self.emit(target, _BINOPS[opty], (lhs, rhs))
        raise DFGError(f"unsupported expression {ast.dump(e)}")


def build_dfg(name: str, inputs: list[str], source: str,
              outputs: list[str]) -> DFG:
    """Compile a kernel body (sequence of assignments) to a DFG."""
    tree = ast.parse(source)
    b = _NodeEmitter(inputs)
    for stmt in tree.body:
        if not isinstance(stmt, ast.Assign) or len(stmt.targets) != 1 \
                or not isinstance(stmt.targets[0], ast.Name):
            raise DFGError("kernel body must be simple assignments")
        tgt = stmt.targets[0].id
        v = b.eval_expr(stmt.value, target=tgt)
        if isinstance(v, (int, float)):
            raise DFGError(f"{tgt!r} is a constant; fold it instead")
    return DFG.build(name, inputs, b.nodes, outputs)
