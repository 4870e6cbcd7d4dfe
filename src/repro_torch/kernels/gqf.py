"""The quotient filter's serial insert and delete: the CUDA kernels'
bindings.

``csrc/gqf_serial.cu`` holds G1 (``gqf_insert_serial``) and G2
(``gqf_delete_serial``), one thread each, which replace the compiled
device loops of ``repro/filters/quotient.py`` (``insert``, ``delete``).
Their plain versions, the same loops on host integers, are
``kernels.ref.gqf_insert_plain`` / ``gqf_delete_plain``;
``kernels.ops.gqf_insert`` / ``gqf_delete`` pick one by the device the
table lives on.
"""

from __future__ import annotations

import torch

from . import build


def _launch(export: str, table, rem, home, valid, ok, count,
            remainder_bits: int, max_probe: int) -> None:
    rc = getattr(build.load("gqf_serial"), export)(
        table.data_ptr(), rem.data_ptr(), home.data_ptr(), valid.data_ptr(),
        ok.data_ptr(), count.data_ptr(), rem.shape[0], table.shape[0],
        remainder_bits, max_probe,
        torch.cuda.current_stream(table.device).cuda_stream)
    build.check(rc, export)


def gqf_insert_launch(table, rem, home, valid, ok, count, remainder_bits: int,
                      max_probe: int) -> None:
    """Launch G1 on the current stream (arguments already checked: table
    int32[num_slots], rem and home int32[n] holding uint32 bits, valid and
    ok bool[n], count int32[], all on one device and contiguous)."""
    _launch("gqf_insert_serial_launch", table, rem, home, valid, ok, count,
            remainder_bits, max_probe)


def gqf_delete_launch(table, rem, home, valid, ok, count, remainder_bits: int,
                      max_probe: int) -> None:
    """Launch G2 on the current stream (arguments as :func:`gqf_insert_launch`)."""
    _launch("gqf_delete_serial_launch", table, rem, home, valid, ok, count,
            remainder_bits, max_probe)
