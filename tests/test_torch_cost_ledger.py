"""The port's cost ledger (``mxnet_tpu_torch.profiling``: ``hlo``,
``optrace``, ``ledger``, ``xplane``) against the JAX package's
(tests/test_profiling.py):

- an HLO text prices into the JAX package's document, value for value,
  through the port's own copy of the parser (the JAX tests' fixture and
  the HLO of a small function JAX compiles here), and its liveness
  ledger too;
- the port's protobuf reader gives the JAX reader's planes;
- one symbol JSON priced by both packages (the JAX executor's compiled
  forward, the port's op trace of its executor): the Convolution and
  FullyConnected FLOPs equal, the totals within the stated bound;
- a fused ``_sg_xla_*`` cluster carries its rule;
- a hand kernel's wrapper is one row with the function's count on the
  CPU, forward and backward, none of its plain version's ops priced;
- the port's documents render through ``tools/mfu_report.py`` (table and
  ``--diff``), which checks their schema.
"""
import torch_test_env  # noqa: F401  (first: one torch thread a process)

import json
import os
import sys

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu.profiling import ledger as jledger
from mxnet_tpu.profiling import memory as jmemory
from mxnet_tpu.profiling import xplane as jxplane
from mxnet_tpu_torch.ops import attention as att
from mxnet_tpu_torch.profiling import hlo, ledger, memory, optrace, xplane

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = os.path.join(REPO, "tools")

# tests/test_profiling.py's fixture, verbatim
_HLO_FIXTURE = """\
HloModule test_mod, entry_computation_layout={(f32[4,8]{1,0})->f32[]}

%fused_add (p0: f32[4,8], p1: f32[4,8]) -> f32[4,8] {
  %p0 = f32[4,8]{1,0} parameter(0)
  %p1 = f32[4,8]{1,0} parameter(1)
  ROOT %add.1 = f32[4,8]{1,0} add(f32[4,8]{1,0} %p0, f32[4,8]{1,0} %p1), metadata={op_name="jit(f)/jit(main)/add"}
}

ENTRY %main.9 (Arg_0.1: f32[4,8]) -> f32[] {
  %Arg_0.1 = f32[4,8]{1,0} parameter(0)
  %w = f32[8,16]{1,0} constant({...})
  %dot.2 = f32[4,16]{1,0} dot(f32[4,8]{1,0} %Arg_0.1, f32[8,16]{1,0} %w), lhs_contracting_dims={1}, rhs_contracting_dims={0}, metadata={op_name="jit(f)/jit(main)/jit(fully_connected)/dot_general" source_file="x.py" source_line=4}
  %conv.3 = f32[4,4,4,16]{3,2,1,0} convolution(f32[4,4,4,8]{3,2,1,0} %Arg_r, f32[3,3,8,16]{3,2,1,0} %w2), window={size=3x3 pad=1_1x1_1}, dim_labels=b01f_01io->b01f, metadata={op_name="jit(f)/mx.Convolution/conv_general_dilated"}
  %fusion.4 = f32[4,8]{1,0} fusion(f32[4,8]{1,0} %Arg_0.1, f32[4,8]{1,0} %Arg_0.1), kind=kLoop, calls=%fused_add
  %ar.5 = f32[4,8]{1,0} all-reduce(f32[4,8]{1,0} %fusion.4), replica_groups={}, to_apply=%fused_add
  ROOT %reduce.6 = f32[] reduce(f32[4,8]{1,0} %ar.5, f32[] %Arg_0.1), dimensions={0,1}, to_apply=%fused_add, metadata={op_name="jit(f)/jit(main)/reduce_sum"}
}
"""
_FN_MAP = {"fully_connected": "FullyConnected"}
_RULE_MAP = {"_sg_xla_conv": "XLA/conv_bn_add_relu"}
_PEAKS = dict(peak_tflops=100.0, peak_hbm_gbs=1000.0)


def _jax_hlo_text():
    """The optimized HLO of a small MLP step JAX compiles here."""
    import jax
    import jax.numpy as jnp

    def f(x, w1, w2):
        h = jnp.maximum(x @ w1, 0.0)
        return jnp.sum(jnp.tanh(h @ w2) ** 2)
    args = [jnp.ones((8, 16)), jnp.ones((16, 32)), jnp.ones((32, 4))]
    return jax.jit(jax.grad(f, argnums=(1, 2))).lower(*args).compile() \
        .as_text()


@pytest.mark.parametrize("which", ["fixture", "jax_compiled"])
def test_hlo_text_ledger_equals_the_jax_packages(which):
    text = _HLO_FIXTURE if which == "fixture" else _jax_hlo_text()
    mine = ledger.build_ledger(text, fn_map=_FN_MAP, rule_map=_RULE_MAP,
                               **_PEAKS)
    theirs = jledger.build_ledger(text, fn_map=_FN_MAP, rule_map=_RULE_MAP,
                                  **_PEAKS)
    assert mine == theirs
    assert mine["rows"]
    assert ledger.summarize(mine) == jledger.summarize(theirs)
    assert ledger.mfu_estimate(mine, 8, 1e-3) == \
        jledger.mfu_estimate(theirs, 8, 1e-3)
    assert json.dumps(memory.build_memory_ledger(
        text, fn_map=_FN_MAP, rule_map=_RULE_MAP)) == json.dumps(
        jmemory.build_memory_ledger(text, fn_map=_FN_MAP,
                                    rule_map=_RULE_MAP))


def test_hlo_module_parse_equals_the_jax_packages():
    from mxnet_tpu.profiling import hlo as jhlo
    mine, theirs = hlo.parse_module(_HLO_FIXTURE), \
        jhlo.parse_module(_HLO_FIXTURE)
    assert (mine.name, mine.entry) == (theirs.name, theirs.entry)
    for a, b in zip(mine.entry_instructions, theirs.entry_instructions):
        assert [getattr(a, s) for s in hlo.Instr.__slots__] == \
            [getattr(b, s) for s in jhlo.Instr.__slots__]
        assert hlo.instr_cost(a, mine) == jhlo.instr_cost(b, theirs)
    assert hlo.TRIVIAL_OPCODES == jhlo.TRIVIAL_OPCODES


# ---- the protobuf reader: the JAX tests' synthetic fixtures ---------------
def _varint(n):
    out = b""
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out += bytes([b | 0x80])
        else:
            return out + bytes([b])


def _field(fn, wt, payload):
    tag = _varint((fn << 3) | wt)
    if wt == 2:
        return tag + _varint(len(payload)) + payload
    return tag + _varint(payload)


def _xspace(plane_name, line_name, metas, events, ts_ns=0):
    meta_msgs = b"".join(
        _field(4, 2, _field(1, 0, mid)
               + _field(2, 2, _field(1, 0, mid)
                        + _field(2, 2, name.encode())))
        for mid, name in metas.items())
    line = (_field(2, 2, line_name.encode()) + _field(3, 0, ts_ns)
            + b"".join(_field(4, 2, _field(1, 0, e[0]) + _field(2, 0, e[1])
                                 + _field(3, 0, e[2])) for e in events))
    plane = (_field(2, 2, plane_name.encode()) + meta_msgs
             + _field(3, 2, line))
    return _field(1, 2, plane)


@pytest.mark.parametrize("case", [
    ("/device:TPU:0", "XLA Ops", {1: "dot.2", 2: "fusion.4.clone"},
     [(1, 1000, 5000), (2, 7000, 2000)], 10),
    ("/device:TPU:0", "XLA Ops", {1: "call.1", 2: "fused.2", 3: "dot.3"},
     [(1, 0, 10000), (2, 1000, 8000), (3, 20000, 4000)], 0),
    ("/host:CPU", "tf_XLAEigen", {1: "convolution.1"},
     [(1, 5, 300)], 7)])
def test_parse_xspace_equals_the_jax_readers(case, tmp_path):
    data = _xspace(*case)
    planes = xplane.parse_xspace(data)
    assert planes == jxplane.parse_xspace(data)
    names = set(case[2].values())
    assert xplane.measure_ops(planes, names) == \
        jxplane.measure_ops(planes, names)
    path = tmp_path / "host.xplane.pb"
    path.write_bytes(data)
    assert xplane.load_xspace(str(tmp_path)) == planes


# ---- one symbol through both packages -------------------------------------
def _net(mx):
    data = mx.sym.var("data")
    net = mx.sym.Convolution(data, num_filter=8, kernel=(3, 3), pad=(1, 1),
                             no_bias=True, name="conv")
    net = mx.sym.BatchNorm(net, fix_gamma=False, name="bn")
    net = mx.sym.Activation(net, act_type="relu", name="relu")
    net = mx.sym.FullyConnected(mx.sym.flatten(net), num_hidden=10,
                                name="fc")
    return mx.sym.SoftmaxOutput(net, name="softmax")


def _values(sym, shape, **more):
    rng = np.random.default_rng(0)
    arg_shapes, _, aux_shapes = sym.infer_shape(data=shape, **more)
    args = {n: (rng.standard_normal(s) * 0.1).astype(np.float32)
            for n, s in zip(sym.list_arguments(), arg_shapes)}
    aux = {n: np.abs(rng.standard_normal(s)).astype(np.float32) + 0.5
           for n, s in zip(sym.list_auxiliary_states(), aux_shapes)}
    return args, aux


def _hlo_with_operand_shapes(compiled):
    """The optimized HLO printed with each operand's shape, the format
    the JAX package's parser reads: this JAX's ``as_text()`` prints
    operands by name alone, and the parser then takes every product's
    contraction (a dot's K, a convolution's input channels) as 1."""
    from jax._src.lib import xla_client
    opts = xla_client._xla.HloPrintOptions()
    opts.print_operand_shape = True
    opts.print_metadata = True
    return compiled.runtime_executable().hlo_modules()[0].to_string(opts)


# JAX's ledger prices the program XLA optimized: BatchNorm's inference
# arithmetic folds into fewer fused instructions than the port's eager
# ops (and the port prices the softmax's max / exp / sum / divide as one
# reduction and three elementwise ops a value). What the two count the
# same way are the products; the other ops are a small share of this
# net's FLOPs, so the totals agree within 10%.
_TOTAL_FLOPS_RTOL = 0.10


def test_symbol_priced_by_both_packages():
    import jax
    shape = (2, 3, 16, 16)
    jsym, tsym = _net(jmx), _net(tmx)
    args, aux = _values(tsym, shape, softmax_label=(2,))
    jex = jsym.simple_bind(jmx.cpu(), data=shape, softmax_label=(2,),
                           grad_req="null")
    for n, v in args.items():
        jex.arg_dict[n][:] = v
    for n, v in aux.items():
        jex.aux_dict[n][:] = v
    arg_vals = {n: a._data for n, a in jex.arg_dict.items()}
    aux_vals = {n: a._data for n, a in jex.aux_dict.items()}
    compiled = jex._jitted_forward(False).lower(
        arg_vals, aux_vals, jax.random.PRNGKey(0)).compile()
    theirs = jledger.build_ledger(_hlo_with_operand_shapes(compiled),
                                  **_PEAKS)
    tex = tsym.simple_bind(tmx.cpu(), data=shape, softmax_label=(2,),
                           grad_req="null")
    for n, v in args.items():
        tex.arg_dict[n][:] = v
    for n, v in aux.items():
        tex.aux_dict[n][:] = v
    mine = ledger.from_compiled(tex, **_PEAKS)
    jby = {g["op"]: g for g in theirs["by_op"]}
    tby = {g["op"]: g for g in mine["by_op"]}
    assert tby["Convolution"]["flops"] == jby["Convolution"]["flops"] \
        == 2 * (2 * 8 * 16 * 16) * 3 * 9
    # FullyConnected: the same dot; the port's addmm counts its bias add
    # (one flop an output) where XLA fuses that add into the next op's
    # fusion, which its ledger keys to SoftmaxOutput
    assert jby["FullyConnected"]["flops"] == 2 * 2 * 10 * 8 * 16 * 16
    assert tby["FullyConnected"]["flops"] == \
        jby["FullyConnected"]["flops"] + 2 * 10
    ratio = mine["totals"]["flops"] / theirs["totals"]["flops"]
    assert abs(ratio - 1) <= _TOTAL_FLOPS_RTOL, ratio
    assert "flops_vs_xla" not in mine
    assert mine["kind"] == theirs["kind"] == "cost_ledger"
    assert set(mine["rows"][0]) >= {"instr", "hlo_op", "op", "flops",
                                    "bytes", "est_s", "bound"}


def test_fused_cluster_carries_its_rule():
    """A Conv + BN + relu chain the XLA fleet fuses into ``_sg_xla_conv``
    prices under that op with the rule attached, as in the JAX ledger."""
    shape = (2, 3, 16, 16)
    data = tmx.sym.var("data")
    net = tmx.sym.Convolution(data, num_filter=8, kernel=(3, 3),
                              pad=(1, 1), no_bias=True, name="conv")
    net = tmx.sym.BatchNorm(net, fix_gamma=False, name="bn")
    net = tmx.sym.Activation(net, act_type="relu", name="relu")
    fused = net.get_backend_symbol("XLA")
    assert any(n.op == "_sg_xla_conv" for n in fused._topo() if n.op)
    args, aux = _values(net, shape)
    ex = fused.simple_bind(tmx.cpu(), data=shape, grad_req="null")
    for n, v in args.items():
        ex.arg_dict[n][:] = v
    for n, v in aux.items():
        ex.aux_dict[n][:] = v
    doc = ledger.from_compiled(ex)
    (g,) = [g for g in doc["by_op"] if g["op"] == "_sg_xla_conv"]
    assert g["rule"] == "XLA/conv_bn_add_relu"
    assert g["flops"] >= 2 * 2 * 8 * 16 * 16 * 3 * 9
    assert all(r.get("rule") == "XLA/conv_bn_add_relu"
               for r in doc["rows"] if r["op"] == "_sg_xla_conv")


# ---- the hand kernels: one row each, the function's count -----------------
def _qkv(b=2, h=3, t=24, d=16, grad=False):
    g = torch.Generator().manual_seed(0)
    return [torch.randn(b, h, t, d, generator=g).requires_grad_(grad)
            for _ in range(3)]


def test_flash_attention_one_row_forward_and_backward():
    """On the CPU the wrapper runs the plain version (dozens of aten ops,
    forward and backward); the trace holds one row for each, with the
    kernel's own count, under the op's scope."""
    q, k, v = _qkv(grad=True)
    qn, kn, vn = (tmx.nd.NDArray(x) for x in (q, k, v))

    def step():
        with tmx.autograd.record():
            out = tmx.nd._contrib_flash_attention(qn, kn, vn, causal=True)
        out.backward()
        return out
    for x in (qn, kn, vn):
        x.attach_grad()
    trace, out = optrace.record(step)
    kernels = [e for e in trace.entries if e["kernel"]]
    assert [e["name"] for e in kernels] == ["flash_attention",
                                            "flash_attention_bwd"]
    assert [e["scopes"][-1] for e in kernels] == [
        "_contrib_flash_attention#0", "_contrib_flash_attention#0.bwd"]
    # nothing else in those scopes: the plain version's ops are not priced
    assert not [e for e in trace.entries if not e["kernel"] and e["scopes"]
                and e["scopes"][-1].startswith("_contrib_flash_attention")]
    fwd_flops, fwd_bytes = att.flash_count(q, k, v, causal=True)
    bwd_flops, bwd_bytes = att.flash_bwd_count(q, k, v, causal=True)
    pairs = 24 * 25 // 2
    assert fwd_flops == 4 * 16 * 2 * 3 * pairs
    assert bwd_flops == 10 * 16 * 2 * 3 * pairs
    assert bwd_bytes == 4 * 2 * 3 * (8 * 24 * 16 + 24)
    assert [(e["flops"], e["bytes"]) for e in kernels] == [
        (fwd_flops, fwd_bytes), (bwd_flops, bwd_bytes)]
    doc = ledger.build_ledger(trace)
    rows = {r["instr"]: r for r in doc["rows"]}
    assert rows["_contrib_flash_attention#0/flash_attention"]["op"] == \
        "_contrib_flash_attention"
    assert rows["_contrib_flash_attention#0.bwd/flash_attention_bwd"][
        "hlo_op"] == "flash_attention_bwd"
    # the recorded call computed what the unrecorded one does
    ref = att.flash_attention_plain(q.detach(), k.detach(), v.detach(),
                                    True, 16 ** -0.5)
    torch.testing.assert_close(out._data.detach(), ref, rtol=0, atol=0)


@pytest.mark.parametrize("kernel", ["int8_conv_epilogue", "fused_sgd_mom",
                                    "fused_adam", "paged_attention"])
def test_other_kernels_one_row_each(kernel):
    from mxnet_tpu_torch.ops import fused_opt, int8
    g = torch.Generator().manual_seed(0)
    if kernel == "int8_conv_epilogue":
        acc = torch.randint(-2 ** 20, 2 ** 20, (2, 4, 5, 5), generator=g,
                            dtype=torch.int32)
        call = lambda: int8.int8_conv_epilogue(  # noqa: E731
            acc, np.float32(1e-4), np.float32(3.0), relu=True)
        want = (2 * acc.numel(), 5 * acc.numel())
    elif kernel == "paged_attention":
        q = torch.randn(2, 2, 8, generator=g)
        kc = torch.randn(6, 4, 2, 8, generator=g)
        vc = torch.randn(6, 4, 2, 8, generator=g)
        tables = torch.tensor([[1, 2, 0], [3, 4, 5]], dtype=torch.int32)
        lens = torch.tensor([6, 11], dtype=torch.int32)
        call = lambda: att.paged_attention(  # noqa: E731
            q, kc, vc, tables, lens)
        want = (4 * 2 * 8 * 17, 2 * 2 * 2 * 8 * 4 + 2 * 17 * 2 * 8 * 4
                + 6 * 4 + 2 * 4)
    else:
        w, gr, m, var = (torch.randn(1000, generator=g) for _ in range(4))
        if kernel == "fused_sgd_mom":
            call = lambda: fused_opt.fused_sgd_mom(  # noqa: E731
                w, gr, m, lr=0.1, momentum=0.9, out=(w, m))
            want = (7 * 1000, 20 * 1000)
        else:
            var = var.abs()
            call = lambda: fused_opt.fused_adam(  # noqa: E731
                w, gr, m, var, lr=0.01, out=(w, m, var))
            want = (15 * 1000, 28 * 1000)
    trace, _ = optrace.record(call)
    assert [(e["name"], e["flops"], e["bytes"]) for e in trace.entries] \
        == [(kernel,) + want]


# ---- the JAX package's report tool reads the port's documents -------------
def test_mfu_report_renders_the_ports_documents(tmp_path):
    sys.path.insert(0, TOOLS)
    import mfu_report

    x = torch.ones(4, 8)
    w = torch.ones(16, 8)

    def fwd(scale):
        def f():
            y = tmx.nd.FullyConnected(tmx.nd.NDArray(x), tmx.nd.NDArray(w),
                                      no_bias=True, num_hidden=16)
            return tmx.nd.relu(y * scale)
        return f
    before = ledger.from_fn(fwd(1.0), **_PEAKS)
    after = ledger.from_fn(fwd(2.0), **_PEAKS)
    pa, pb = str(tmp_path / "a.json"), str(tmp_path / "b.json")
    ledger.dump(before, pa)
    ledger.dump(after, pb)
    assert ledger.load(pa) == json.loads(json.dumps(before))
    table = mfu_report.format_table(ledger.load(pa))
    assert "FullyConnected" in table and "relu" in table
    assert mfu_report.main([pa]) == 0
    assert mfu_report.main(["--diff", pa, pb]) == 0
    d = ledger.diff(before, after)
    assert {r["op"] for r in d} == {g["op"] for g in before["by_op"]}
    run = tmx.profiling.attribution_run(fwd(1.0), steps=1,
                                        profile_dir=str(tmp_path / "cap"))
    assert "measured" in mfu_report.format_table(run) or \
        run["kind"] == "mfu_attribution"
    assert mfu_report.main([_dump(run, tmp_path / "run.json")]) == 0


def _dump(doc, path):
    ledger.dump(doc, str(path))
    return str(path)
