"""Unit tests for tools/exact_join.py — the HLO-text parser, the
event-class attribution and the join of GPU trace events to the HLO.

These pin the failure modes that silently produce wrong profiles:
tuple-typed instructions skipped by the parser (copy-start/while),
full-HLO-line trace names not matching bare instruction names, fusion
classification ignoring the fused computation's ops, cuDNN/cuBLAS
custom-calls not counted as convs/matmuls, and kernels of host planes or
of other programs counted against the step.
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))

from exact_join import classify, parse_hlo  # noqa: E402

HLO = """\
HloModule jit_step, entry_computation_layout={(f32[8,8]{1,0})->f32[8,8]{1,0}}

%fused_computation.1 (param_0: bf16[4,4]) -> bf16[4,4] {
  %param_0 = bf16[4,4]{1,0} parameter(0)
  %c = bf16[4,4]{1,0} convolution(bf16[4,4]{1,0} %param_0, bf16[4,4]{1,0} %param_0), metadata={op_name="jit(step)/conv_general_dilated" source_file="x.py"}
  ROOT %m = bf16[4,4]{1,0} multiply(bf16[4,4]{1,0} %c, bf16[4,4]{1,0} %c)
}

%wgrad_computation (p: bf16[4,4]) -> bf16[4,4] {
  %p = bf16[4,4]{1,0} parameter(0)
  ROOT %cg = bf16[4,4]{1,0} convolution(bf16[4,4]{1,0} %p, bf16[4,4]{1,0} %p), metadata={op_name="jit(step)/transpose(jvp(conv))/conv_general_dilated"}
}

%body (arg: (s32[], f32[8,8])) -> (s32[], f32[8,8]) {
  %arg = (s32[], f32[8,8]{1,0}) parameter(0)
  %gte = s32[] get-tuple-element((s32[], f32[8,8]{1,0}) %arg), index=0
  %copy-start.20 = (f32[3,3,128,128]{3,2,1,0:T(8,128)}, f32[3,3,128,128]{3,2,1,0:T(8,128)S(1)}, u32[]{:S(2)}) copy-start(f32[3,3,128,128]{3,2,1,0:T(8,128)S(1)} %gte)
  %fusion.7 = bf16[4,4]{1,0} fusion(bf16[4,4]{1,0} %gte), kind=kOutput, calls=%fused_computation.1
  %fusion.8 = bf16[4,4]{1,0} fusion(bf16[4,4]{1,0} %gte), kind=kOutput, calls=%wgrad_computation
  ROOT %r = (s32[], f32[8,8]{1,0}) tuple(s32[] %gte, f32[8,8]{1,0} %gte)
}

ENTRY %main (x: f32[8,8]) -> f32[8,8] {
  %x = f32[8,8]{1,0} parameter(0)
  %w = (s32[], f32[8,8]{1,0}) while((s32[], f32[8,8]{1,0}) %x), condition=%cond, body=%body
  %red = f32[8]{0} reduce(f32[8,8]{1,0} %x, f32[] %x), dimensions={1}
  ROOT %out = f32[8,8]{1,0} copy(f32[8,8]{1,0} %x)
}
"""


def test_parse_hlo_covers_every_computation_and_tuple_types():
    table = parse_hlo(HLO)
    # tuple-typed instructions (the round-5 parser fix): copy-start's type
    # contains nested parens from tile specs — must still be parsed
    assert "copy-start.20" in table
    assert table["copy-start.20"][0] == "copy-start"
    # while-body instructions are in the table (hot ops live there under
    # a lax.scan dispatch), not just ENTRY
    assert "fusion.7" in table and "gte" in table
    assert table["w"][0] == "while"
    assert table["red"][0] == "reduce"


def test_fusion_classification_uses_fused_computation():
    table = parse_hlo(HLO)
    # fusion.7 wraps a FORWARD conv: must classify as conv.fwd even though
    # its own opcode is just "fusion" (the round-4 name-only-bucketing bug)
    assert classify(*table["fusion.7"]) == "conv.fwd"
    # fusion.8 wraps a transpose()-marked conv -> backward
    assert classify(*table["fusion.8"]) == "conv.bwd"
    assert classify(*table["copy-start.20"]) == "async copy"
    assert classify(*table["red"]) == "reduce"
    assert classify(*table["w"]) == "control"
    assert classify(*table["out"]) == "layout/copy"


def test_trace_event_name_extraction():
    # device traces can name events with the full HLO line; the join keys
    # on the token before " = " (see exact_join.run)
    ev = ("%copy-start.20 = (f32[3,3,128,128]{3,2,1,0:T(8,128)}, "
          "u32[]{:S(2)}) copy-start(f32[...] %gte)")
    name = ev.split(" = ")[0].strip().lstrip("%")
    assert name == "copy-start.20"
    assert name in parse_hlo(HLO)


def test_layer_attribution_handles_ad_wrapped_scopes():
    from exact_join import layer_of

    # bare path component, jvp-wrapped, transpose(jvp)-wrapped
    assert layer_of("jit(step)/conv1/conv_general_dilated", []) == "conv1"
    assert layer_of("jit(steps)/while/body/jvp(conv_input)/conv", []) == \
        "conv_input"
    assert layer_of(
        "transpose(jvp(up2_conv1))/conv_general_dilated", []) == "up2_conv1"
    # up{j}_conv2x2 must NOT partially match as conv2
    assert layer_of("jvp(up1_conv2x2)/conv", []) == "up1_conv2x2"
    # a fusion spanning two layers is 'mixed'; attribution looks at the
    # fused computation's metadata too
    assert layer_of("", [("convolution", "jvp(conv2)/x"),
                         ("convolution", "jvp(conv3)/y")]) == "mixed:conv2+conv3"
    # no scope anywhere -> unscoped (conv_general_dilated must not match)
    assert layer_of("jit(step)/conv_general_dilated", []) == "(unscoped)"


GPU_HLO = """\
HloModule jit_step, is_scheduled=true

ENTRY %main (x: f32[2,8,8,1]) -> f32[2,6,6,4] {
  %x = f32[2,8,8,1]{3,2,1,0} parameter(0)
  %cudnn-conv.54 = (f32[2,6,6,4]{3,2,1,0}, u8[0]{0}) custom-call(%x, %x), window={size=3x3}, custom_call_target="__cudnn$convForward", metadata={op_name="jit(step)/jvp(conv_input)/conv_general_dilated"}
  %cudnn-conv-bw-filter.3 = (f32[3,3,1,4]{3,2,1,0}, u8[0]{0}) custom-call(%x, %x), custom_call_target="__cudnn$convBackwardFilter", metadata={op_name="jit(step)/transpose(jvp(conv1))/conv_general_dilated"}
  %gemm.1 = (f32[4,4]{1,0}, s8[0]{0}) custom-call(%x, %x), custom_call_target="__cublas$gemm", metadata={op_name="jit(step)/dot_general"}
  %loop_add_fusion.19 = f32[2,6,6,4]{3,2,1,0} fusion(%x), kind=kLoop, calls=%fused_add
  ROOT %copy.3 = f32[2,6,6,4]{3,2,1,0} copy(%x)
}
"""


def test_gpu_custom_calls_classify_as_the_ops_they_run():
    table = parse_hlo(GPU_HLO)
    assert classify(*table["cudnn-conv.54"]) == "conv.fwd"
    assert classify(*table["cudnn-conv-bw-filter.3"]) == "conv.bwd"
    assert classify(*table["gemm.1"]) == "dot"
    assert classify(*table["copy.3"]) == "layout/copy"


def _space():
    """A hand-built parsed trace: one GPU device plane with two streams,
    a host plane whose events also carry hlo_op (must be ignored), and a
    kernel of another program (must not count)."""
    from supernet_tpu.xplane import Event

    def ev(op, start, dur, module="jit_step"):
        return Event(op.replace(".", "_"), dur,
                     {"hlo_op": op, "hlo_module": module}, start)

    return {
        "/host:CPU": {"python": [ev("cudnn-conv.54", 0, 10_000)]},
        "/device:GPU:0": {
            "Stream #13(Compute)": [
                ev("cudnn-conv.54", 0, 4_000),
                ev("loop_add_fusion.19", 5_000, 1_000),
                ev("fusion.999", 6_000, 500),  # not in this HLO
                ev("cudnn-conv.54", 20_000, 7_000, module="jit_other"),
            ],
            "Stream #31(Compute)": [
                ev("cudnn-conv-bw-filter.3", 2_000, 2_000),  # overlaps
                ev("copy.3", 8_000, 1_000),
            ],
        },
    }


def test_join_selects_gpu_planes_and_joins_by_hlo_op():
    from exact_join import join_events, module_name

    table = parse_hlo(GPU_HLO)
    j = join_events(_space(), table, module_name(GPU_HLO), by_layer=True)
    assert module_name(GPU_HLO) == "jit_step"
    assert j["joined"] == 4
    assert dict(j["classes"]) == {
        "conv.fwd": [4_000, 1], "conv.bwd": [2_000, 1],
        "elementwise": [1_000, 1], "layout/copy": [1_000, 1]}
    assert dict(j["unmatched"]) == {"fusion": [500, 1]}
    # busy = union of [0,4000) [2000,4000) [5000,6500) [8000,9000)
    assert j["busy_ps"] == 4_000 + 1_500 + 1_000
    assert j["layers"][("conv_input", "conv.fwd")] == [4_000, 1]
    assert j["layers"][("conv1", "conv.bwd")] == [2_000, 1]


def test_join_without_gpu_events_raises():
    import pytest

    from exact_join import join_events

    table = parse_hlo(GPU_HLO)
    space = _space()
    with pytest.raises(ValueError, match="no GPU kernel event"):
        join_events({"/host:CPU": space["/host:CPU"]}, table, "jit_step")
    with pytest.raises(ValueError, match="no GPU kernel event"):
        join_events(space, table, "jit_some_other_program")
