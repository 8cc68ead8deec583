"""The roofline's yardstick (``pmgbench/counts.py``) at the cells' sizes,
against numbers worked by hand."""

import pytest

from pmgbench import counts


def test_q4_r6_3d():
    # n = 5: a line takes 5 * 3 = 15 FMAs; a cell 4 * 3 * 25 * 15 + 3 * 125
    assert counts.line_fmas(5) == 15
    assert counts.cell_fmas(3, 4) == 4875
    assert counts.fine_apply_fmas(3, 4, 6) == 262144 * 4875 == 1277952000
    assert counts.n_dofs(3, 4, 6) == 257 ** 3 == 16974593
    assert counts.fine_apply_bytes(3, 4, 6, "float32") == 135796744
    assert counts.fine_apply_bytes(3, 4, 6, "float64") == 271593488
    s, by = counts.fine_apply_bound_s(3, 4, 6, "float32")
    assert by == "bytes" and s == pytest.approx(135796744 / 3.35e12)
    s, by = counts.fine_apply_bound_s(3, 4, 6, "float64")
    assert by == "bytes" and s == pytest.approx(271593488 / 3.35e12)
    # the operations' time beside it: 2 * 1.278e9 / 67e12 = 38.1 us
    assert 2 * 1277952000 / 67e12 == pytest.approx(3.8148e-5, rel=1e-4)


def test_q7_r9_2d():
    # n = 8: a line takes 8 * 4 = 32 FMAs; a cell 4 * 2 * 8 * 32 + 2 * 64
    assert counts.line_fmas(8) == 32
    assert counts.cell_fmas(2, 7) == 2176
    assert counts.fine_apply_fmas(2, 7, 9) == 262144 * 2176 == 570425344
    assert counts.n_dofs(2, 7, 9) == 3585 ** 2 == 12852225
    assert counts.fine_apply_bytes(2, 7, 9, "float32") == 102817800
    s, by = counts.fine_apply_bound_s(2, 7, 9, "float32")
    assert by == "bytes" and s == pytest.approx(3.0692e-5, rel=1e-4)


def test_operations_bind_at_high_degree():
    # Q8 in 3D: n = 9, 4 * 3 * 81 * 45 + 3 * 729 = 45927 FMAs a cell; on
    # 8^3 cells 2 * 512 * 45927 / 67e12 = 0.702 us against 65^3 points'
    # 2 * 274625 * 4 / 3.35e12 = 0.656 us of bytes
    assert counts.cell_fmas(3, 8) == 45927
    s, by = counts.fine_apply_bound_s(3, 8, 3, "float32")
    assert by == "operations" and s == pytest.approx(7.0193e-7, rel=1e-4)
