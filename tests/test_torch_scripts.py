"""The port's measurement scripts that run without a card: the trace
summary, and the fused-scan probe's source substitutions (every variant's
anchor text must still be in csrc/outer_cumsum.cu, or the probe fails on
the card)."""
import json

import pytest

from naruto_tpu_torch.scripts import probe_outer_scan, trace_summary


@pytest.mark.parametrize("name,short", [
    ("void (anonymous namespace)::outer_scan_kernel<4, true>(__nv_bfloat16 "
     "const*, int)", "outer_scan_kernel"),
    ("void at::native::elementwise_kernel<128, 4, at::native::(anonymous "
     "namespace)::OpType>(int)", "elementwise_kernel"),
    ("ncclKernel_AllReduce", "ncclKernel_AllReduce"),
])
def test_short_name(name, short):
    assert trace_summary.short_name(name) == short


def test_trace_summary_keys_by_operator_and_port_grid(tmp_path, capsys):
    """Kernels are keyed by the innermost operator with their external id;
    the port's kernels (anonymous namespace) also by grid."""
    ev = [
        {"cat": "cpu_op", "name": "aten::where", "ts": 1.0,
         "args": {"External id": 7}},
        {"cat": "cpu_op", "name": "outer", "ts": 0.5,
         "args": {"External id": 7}},
        {"cat": "kernel", "name": "void at::native::k<1>(int)", "dur": 3.0,
         "args": {"External id": 7, "grid": [9, 1, 1]}},
        {"cat": "kernel", "name": "void at::native::k<1>(int)", "dur": 1.0,
         "args": {"External id": 7, "grid": [5, 1, 1]}},
        {"cat": "kernel", "name": "void (anonymous namespace)::scan(int)",
         "dur": 2.0, "args": {"External id": 99, "grid": [964, 1, 1]}},
        {"cat": "kernel", "name": "void (anonymous namespace)::scan(int)",
         "dur": 4.0, "args": {"External id": 99, "grid": [8, 1, 1]}},
    ]
    table = trace_summary.summarize(ev)
    assert table[("aten::where", "k")] == [2, 4.0]
    assert table[("-", "scan", (964, 1, 1))] == [1, 2.0]
    assert table[("-", "scan", (8, 1, 1))] == [1, 4.0]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    trace_summary.main([str(path), "--iters", "2"])
    out = capsys.readouterr().out
    assert "4 launches, 10.0 us (2.0 launches and 5.0 us an iteration)" in out


@pytest.mark.parametrize("name", list(probe_outer_scan.VARIANTS))
def test_probe_variants_apply_to_the_source(name):
    code = probe_outer_scan._SRC.read_text()
    subs = probe_outer_scan.VARIANTS[name][0]
    for old, new in subs if subs is not None else \
            probe_outer_scan._timeline(1 << 20):
        assert old in code, (name, old)
        code = code.replace(old, new)
    if name == "tree":
        assert code == probe_outer_scan._SRC.read_text()
