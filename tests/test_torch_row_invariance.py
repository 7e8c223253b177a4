"""`tools.row_invariance` on the CPU: its per-operation check and its report.

* `RowCheck` flags an operation whose first rows change with the batch's
  rows (a flip along the rows) and passes row-local ones (an elementwise
  product, a product with a weight, a bias broadcast along the last axis).
* The whole report at a small width (hidden 32, 12 rows of 12 events): both
  precisions, the prefill at group widths 2, 4 and 8 against each row alone
  and a decode step at 12 slots against 6; kernel B's plain version, which
  runs here, is row-local.
"""

import torch

from eventstreamgpt_tpu_torch.tools.row_invariance import RowCheck, row_invariance

SMALL = dict(sizes=(5, 8, 6, 3), hidden_size=32, head_dim=8, intermediate_size=64, seq_window_size=4)


def test_row_check_flags_an_operation_that_mixes_rows():
    x = torch.randn(8, 5, dtype=torch.float64)
    w, bias = torch.randn(5, 3, dtype=torch.float64), torch.randn(8, dtype=torch.float64)
    check = RowCheck(8, 2)
    with check:
        x.flip(0)
        x * 2.0
        x @ w
        x.T + bias  # a (5, 8) input: its rows are not the batch's
    report = check.report()
    assert [r["op"] for r in report["ops_differing"]] == ["flip"]
    assert report["ops_differing"][0]["calls"] == report["ops_differing"][0]["differ"] == 1
    assert report["ops_checked"] == 3  # flip, mul and matmul; the transposed sum leads with 5 rows


def test_row_check_slices_rows_not_a_broadcast_bias():
    x, bias = torch.randn(4, 6, 4, dtype=torch.float64), torch.randn(4, dtype=torch.float64)
    check = RowCheck(4, 1)
    with check:
        x + bias
    assert check.report()["ops_checked"] == 1 and check.report()["ops_differing"] == []


def test_the_report_at_a_small_width():
    reports = row_invariance("cpu", rows=12, length=12, widths=SMALL)
    assert [r["precision"] for r in reports] == ["bf16", "fp32"]
    for r in reports:
        assert r["hidden"] == 32 and [p["rows"] for p in r["prefill"]] == [[2, 1], [4, 1], [8, 1]]
        assert [p["outputs"]["rows_compared"] for p in r["prefill"]] == [2, 4, 8]
        assert r["decode"]["rows"] == [12, 6] and r["decode"]["outputs"]["rows_compared"] == 6
        assert min(p["ops"]["calls_checked"] for p in r["prefill"]) > 50 and r["decode"]["ops"]["calls_checked"] > 20
        assert r["decode"]["kernel_b_same_input"] == dict(rows_equal=True, max_abs=0.0)
        assert set(r["decode"]["outputs"]["pred_floats_max_abs"]) >= {"time_to_event", "classification['event_type']"}
