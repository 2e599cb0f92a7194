"""One cell's run in one process (or one rank): the mix's program (its
set-up and window, with the reading of a traced window), then the output
check, and with a traced window each item's model FLOPs and least
back-projection time. The program is the module `traffic/<mix>.py` where
the mix brings its own, else `harness/<program>.py` for the mix's
`program` key (`manifest.program`)."""
from __future__ import annotations

from typing import Any, Dict, Optional

from h100bench.harness import manifest as mf


def run(spec: Dict[str, Any], traffic: Dict[str, Any], seed: int,
        seconds: float, trace: bool, device, t_start: float, rank: int = 0,
        system: str = "port", fault: Optional[str] = None,
        ranges: Optional[Dict[str, Any]] = None,
        sample_span: Optional[int] = None):
    """Returns (Record, numbers compared). The reference runs only after
    the peak has been read and the program's state freed."""
    program = mf.program(traffic)
    record, chk = program.run(spec, traffic, seed, seconds, trace, device,
                              t_start, rank=rank, system=system, fault=fault,
                              ranges=ranges, sample_span=sample_span)
    numbers = program.numbers(chk, device)
    if trace:
        record.flops_per_item, record.bp_bound_s_per_item = program.costs(
            spec, chk, device)
    return record, numbers
