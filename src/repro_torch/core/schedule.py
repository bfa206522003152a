"""Operation scheduling onto the linear time-multiplexed FU pipeline.

Implements the paper's scheduling methodology (Section IV, Table I):

  * ASAP staging — every op at ASAP level *s* executes on FU *s* (1-indexed),
    so #FUs = graph depth and the interconnect is a direct FU->FU link.
  * Bypass insertion — a value produced at level *p* and consumed at level
    *c* > *p*+1 occupies one BYP instruction slot in each intermediate FU
    (the linear interconnect is non-programmable, so data can only move one
    stage per pass).  Primary outputs produced before the last stage are
    bypassed to the end so they exit via the output FIFO.
  * Initiation interval —

        II = max_s(loads_s + instrs_s) + 2

    where loads_s is the number of words streamed into FU_s's register file
    per iteration (outputs of FU_{s-1}; primary inputs for FU_1), instrs_s
    counts arithmetic + bypass instructions, and the +2 covers the data
    output cycle and the pipeline flush (paper Section III: gradient II =
    5 loads + 4 ops + 1 out + 1 flush = 11).

  * Single-FU II = inputs + ops + 1 (paper: gradient on one FU = 5 + 11 + 1
    = 17); spatial overlay needs #FUs = op nodes with II = 1.

The cycle-accurate trace generator reproduces Table I: FU_s begins loading
two cycles after FU_{s-1} starts its first arithmetic op (the DSP block's
3-stage internal pipeline => result available 2 cycles after the start).
"""

from __future__ import annotations

import dataclasses

from repro_torch.core.dfg import DFG, Node, Op

#: DSP48E1 internal pipeline: result available start+DSP_LATENCY-1 cycles
#: later (paper: SUB started in cycle 6 arrives at FU1 on cycle 8).
DSP_LATENCY = 3
#: data-output + pipeline-flush cycles charged to the bottleneck stage.
FLUSH_CYCLES = 2


@dataclasses.dataclass(frozen=True)
class Instr:
    """One FU instruction slot (pre-encoding; see isa.py for bit packing)."""

    op: Op
    dest: str                 # value name this slot produces
    args: tuple[str, ...]     # value names read from the local RF
    imm: float | int | None = None
    node: str | None = None   # originating DFG node (None for BYP)


@dataclasses.dataclass
class StageProgram:
    """The instruction memory contents of one FU."""

    stage: int                       # 1-indexed FU position
    loads: tuple[str, ...]           # values streamed into the RF, in order
    instrs: tuple[Instr, ...]        # arithmetic first, then bypasses

    @property
    def n_loads(self) -> int:
        return len(self.loads)

    @property
    def n_instrs(self) -> int:
        return len(self.instrs)

    @property
    def cycles(self) -> int:
        return self.n_loads + self.n_instrs


@dataclasses.dataclass
class Schedule:
    """A DFG mapped onto the linear TM-FU pipeline."""

    dfg: DFG
    stages: tuple[StageProgram, ...]

    # ------------------------------------------------------------ paper model
    @property
    def n_fus(self) -> int:
        return len(self.stages)

    @property
    def ii(self) -> int:
        return max(s.cycles for s in self.stages) + FLUSH_CYCLES

    @property
    def single_fu_ii(self) -> int:
        return len(self.dfg.inputs) + self.dfg.n_ops + 1

    @property
    def spatial_fus(self) -> int:
        return self.dfg.n_ops

    @property
    def eopc(self) -> float:
        """Effective operations per cycle = op_nodes / II (Table II)."""
        return round(self.dfg.n_ops / self.ii, 1)

    @property
    def total_instrs(self) -> int:
        return sum(s.n_instrs for s in self.stages)

    @property
    def max_stage_instrs(self) -> int:
        return max(s.n_instrs for s in self.stages)

    def table2_row(self) -> dict:
        st = self.dfg.stats()
        st.update({"II": self.ii, "eOPC": self.eopc})
        return st

    # --------------------------------------------------------------- trace
    def cycle_trace(self, n_iters: int = 3) -> list[tuple[int, dict[int, str]]]:
        """Cycle-accurate steady-state trace (reproduces Table I).

        Returns [(cycle, {fu_index: activity})]; fu_index is 0-based like the
        paper's FU0..FU3.  Each FU repeats its (load*, op*) pattern with
        period II; FU_{s+1} starts loading DSP_LATENCY-1 cycles after FU_s
        starts its first instruction.
        """
        ii = self.ii
        first_load = []
        t = 1
        for s, prog in enumerate(self.stages):
            first_load.append(t)
            # next stage's first datum arrives when this stage's first op
            # completes the DSP pipeline
            t = t + prog.n_loads + (DSP_LATENCY - 1)
        horizon = first_load[-1] + self.stages[-1].cycles + (n_iters - 1) * ii
        rows: list[tuple[int, dict[int, str]]] = []
        for cyc in range(1, horizon + 1):
            acts: dict[int, str] = {}
            for s, prog in enumerate(self.stages):
                rel = cyc - first_load[s]
                if rel < 0:
                    continue
                ph = rel % ii
                if (cyc - first_load[s]) // ii >= n_iters:
                    continue
                if ph < prog.n_loads:
                    acts[s] = f"Load R{ph}"
                elif ph < prog.cycles:
                    ins = prog.instrs[ph - prog.n_loads]
                    regs = " ".join(
                        f"R{prog.loads.index(a)}" if a in prog.loads else a
                        for a in (ins.args if ins.op is not Op.SQR
                                  else (ins.args[0], ins.args[0])))
                    acts[s] = f"{ins.op.name} ({regs})"
            if acts:
                rows.append((cyc, acts))
        return rows


class ScheduleError(ValueError):
    pass


def schedule(dfg: DFG) -> Schedule:
    """ASAP-schedule ``dfg`` onto the linear TM-FU pipeline."""
    levels = dfg.asap_levels()
    depth = dfg.depth
    if depth == 0:
        raise ScheduleError(f"{dfg.name}: empty DFG")

    # ops per stage (stage s hosts ASAP level s)
    ops_at: dict[int, list[Node]] = {s: [] for s in range(1, depth + 1)}
    for n in dfg.topo_order():
        node = dfg.nodes[n]
        ops_at[levels[n]].append(node)

    # last level at which each value is consumed (outputs live to the end)
    last_use: dict[str, int] = {}
    for n, node in dfg.nodes.items():
        for a in node.args:
            last_use[a] = max(last_use.get(a, 0), levels[n])
    for o in dfg.outputs:
        last_use[o] = depth + 1  # must reach the output FIFO

    # walk the pipeline inserting bypasses: ``live`` is the ordered set of
    # values streamed into stage s (= outputs of stage s-1 / primary inputs)
    stages: list[StageProgram] = []
    live: list[str] = list(dfg.inputs)
    for s in range(1, depth + 1):
        instrs: list[Instr] = [
            Instr(op=node.op, dest=node.name, args=node.args, imm=node.imm,
                  node=node.name)
            for node in ops_at[s]
        ]
        produced = {i.dest for i in instrs}
        # bypass every live value still needed beyond this stage
        for v in live:
            if last_use.get(v, 0) > s and v not in produced:
                instrs.append(Instr(op=Op.BYP, dest=v, args=(v,)))
        stages.append(StageProgram(stage=s, loads=tuple(live),
                                   instrs=tuple(instrs)))
        # the hardware streams EVERY instruction result to the next stage in
        # instruction order; DFG validation guarantees none of them is dead.
        for i_ in instrs:
            if last_use.get(i_.dest, 0) <= s and s < depth:
                raise ScheduleError(
                    f"{dfg.name}: dead value {i_.dest!r} at stage {s}")
        live = [i.dest for i in instrs] if s < depth else \
            [i.dest for i in instrs if last_use.get(i.dest, 0) > s]

    # everything still live after the last stage must be a primary output
    extra = [v for v in live if v not in dfg.outputs]
    if extra:
        raise ScheduleError(f"{dfg.name}: values fall off the pipeline: {extra}")
    return Schedule(dfg=dfg, stages=tuple(stages))
