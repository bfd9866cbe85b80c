"""The port's profiler (``mxnet_tpu_torch.profiler``) against the JAX
package's (``mxnet_tpu.profiler``), on the CPU.

The cases of tests/test_profiler.py run through both packages with only
the import changed: per-op rows and the aggregate table, the refusal of
unknown keys, rows off by default, the device trace started by
``set_config(jax_trace_dir=...)`` (the port's is torch.profiler's chrome
trace), the reset at ``start``, ``continuous_dump`` and the scopes and
counters. Both packages record the same op rows, in the same order, for
the same NDArray program. The port's own rules: ``start()`` with a
trace directory raises while another torch.profiler session runs;
``annotate`` and ``StepTraceAnnotation`` land in the device trace; the
dump holds the telemetry spans in one balanced stream with one tid
space.
"""
import json
import os

import numpy as onp
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu_torch.base import MXNetError
from test_torch_jax_globals import jax_globals  # noqa: F401

PKGS = {'jax': jmx, 'port': mx}


def _reset(m):
    m.profiler.set_config(profile_imperative=False, profile_all=False,
                          aggregate_stats=False, profile_sync=False,
                          jax_trace_dir=None, filename='profile.json',
                          continuous_dump=False)


@pytest.fixture(autouse=True)
def _cpu_and_reset():
    with mx.cpu():
        yield
    for m in PKGS.values():
        m.profiler.stop()
        _reset(m)


def _program(m):
    a = m.nd.ones((16, 16))
    for _ in range(3):
        m.nd.dot(a, a)
    b = m.nd.dot(a, a) + a
    m.nd.sum(m.nd.relu(b - 1))


@pytest.mark.parametrize('pkg', ['jax', 'port'])
def test_per_op_rows_and_aggregate_table(pkg):
    m = PKGS[pkg]
    m.profiler.set_config(profile_imperative=True, aggregate_stats=True)
    m.profiler.start()
    a = m.nd.ones((16, 16))
    for _ in range(3):
        m.nd.dot(a, a)
    m.profiler.stop()
    table = m.profiler.dumps()
    assert 'dot' in table and 'Total Count' in table
    row = [ln for ln in table.splitlines() if ln.startswith('dot')][0]
    assert int(row.split()[1]) == 3
    evs = json.loads(m.profiler.dumps(format='json'))['traceEvents']
    ops = [e for e in evs if e['cat'] == 'operator']
    assert len(ops) >= 3 and all('dur' in e for e in ops)


def test_both_packages_record_the_same_op_rows():
    rows = {}
    for pkg, m in PKGS.items():
        m.profiler.set_config(profile_all=True, profile_sync=True)
        m.profiler.start()
        _program(m)
        m.profiler.stop()
        rows[pkg] = [e['name'] for e in json.loads(
            m.profiler.dumps(format='json'))['traceEvents']
            if e['cat'] == 'operator']
    assert rows['port'] == rows['jax']
    assert rows['port'].count('dot') == 4


def test_set_config_keys_are_the_jax_packages():
    assert set(mx.profiler._config) == set(jmx.profiler._config)


@pytest.mark.parametrize('pkg', ['jax', 'port'])
def test_set_config_rejects_unknown_keys(pkg):
    m = PKGS[pkg]
    with pytest.raises(m.base.MXNetError):
        m.profiler.set_config(not_a_real_key=True)


@pytest.mark.parametrize('pkg', ['jax', 'port'])
def test_profiling_off_by_default(pkg):
    m = PKGS[pkg]
    m.profiler.start()
    a = m.nd.ones((4, 4))
    m.nd.dot(a, a)
    m.profiler.stop()
    evs = json.loads(m.profiler.dumps(format='json'))['traceEvents']
    assert not [e for e in evs if e['cat'] == 'operator']


@pytest.mark.parametrize('pkg', ['jax', 'port'])
def test_device_trace_started_via_api(pkg, tmp_path):
    m = PKGS[pkg]
    m.profiler.set_config(jax_trace_dir=str(tmp_path))
    m.profiler.start()
    m.nd.dot(m.nd.ones((8, 8)), m.nd.ones((8, 8))).wait_to_read()
    m.profiler.stop()
    files = [f for _, _, fs in os.walk(str(tmp_path)) for f in fs]
    assert files, "no device trace written"


def test_port_device_trace_is_torch_profilers_chrome_trace(tmp_path):
    """The trace names the ops torch ran and the annotated ranges."""
    mx.profiler.set_config(jax_trace_dir=str(tmp_path))
    mx.profiler.start()
    with mx.profiler.StepTraceAnnotation(3):
        with mx.profiler.annotate('my_region'):
            mx.nd.dot(mx.nd.ones((8, 8)), mx.nd.ones((8, 8)))
    mx.profiler.stop()
    path = mx.profiler.device_trace_file()
    assert os.path.dirname(path) == str(tmp_path)
    with open(path) as f:
        names = {e.get('name') for e in json.load(f)['traceEvents']}
    assert {'my_region', 'ProfilerStep#3'} <= names
    assert any('mm' in str(n) for n in names)


def test_port_start_refuses_a_second_torch_profiler(tmp_path):
    """torch runs one profiler at a time: start() with a trace directory
    raises, naming it, rather than leave the device trace out; without a
    directory it starts."""
    mx.profiler.set_config(jax_trace_dir=str(tmp_path))
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with pytest.raises(MXNetError, match='torch.profiler'):
            mx.profiler.start()
    mx.profiler.start()
    with pytest.raises(MXNetError, match='already running'):
        mx.profiler.start()
    mx.profiler.stop()
    mx.profiler.set_config(jax_trace_dir=None)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        mx.profiler.start()
        mx.profiler.stop()


@pytest.mark.parametrize('pkg', ['jax', 'port'])
def test_start_clears_events_and_stats(pkg):
    m = PKGS[pkg]
    m.profiler.set_config(profile_imperative=True, aggregate_stats=True)
    m.profiler.start()
    a = m.nd.ones((4, 4))
    m.nd.dot(a, a)
    m.profiler.stop()
    assert json.loads(m.profiler.dumps(format='json'))['traceEvents']
    m.profiler.start()
    assert not json.loads(m.profiler.dumps(format='json'))['traceEvents']
    assert 'dot' not in m.profiler.get_summary()
    m.profiler.stop()


@pytest.mark.parametrize('pkg', ['jax', 'port'])
def test_continuous_dump_extends_file_without_reemitting(pkg, tmp_path):
    m = PKGS[pkg]
    fname = str(tmp_path / 'cont.json')
    m.profiler.set_config(filename=fname, continuous_dump=True)
    m.profiler.start()
    with m.profiler.scope('s1'):
        pass
    m.profiler.dump()
    with open(fname) as f:
        first = json.load(f)['traceEvents']
    assert [e['name'] for e in first].count('s1') == 2
    with m.profiler.scope('s2'):
        pass
    m.profiler.dump()
    with open(fname) as f:
        names = [e['name'] for e in json.load(f)['traceEvents']]
    assert names.count('s1') == 2 and names.count('s2') == 2
    m.profiler.dump()
    with open(fname) as f:
        assert len(json.load(f)['traceEvents']) == 4
    assert not json.loads(m.profiler.dumps(format='json'))['traceEvents']
    m.profiler.start()
    with m.profiler.scope('s3'):
        pass
    m.profiler.dump()
    with open(fname) as f:
        names = [e['name'] for e in json.load(f)['traceEvents']]
    assert names.count('s3') == 2 and 's1' not in names


@pytest.mark.parametrize('pkg', ['jax', 'port'])
def test_scopes_and_counters(pkg, tmp_path):
    m = PKGS[pkg]
    m.profiler.set_config(filename=str(tmp_path / 'p.json'))
    m.profiler.start()
    dom = m.profiler.Domain('test')
    with dom.new_task('work'):
        c = dom.new_counter('ctr', 1)
        c += 2
    dom.new_marker('here').mark()
    m.profiler.stop()
    m.profiler.dump()
    with open(str(tmp_path / 'p.json')) as f:
        evs = json.load(f)['traceEvents']
    names = [e['name'] for e in evs]
    assert 'work' in names and 'ctr' in names and 'here' in names
    assert [e['args']['ctr'] for e in evs if e['name'] == 'ctr'] == [1, 3]


def test_port_dump_merges_spans_in_one_tid_space(tmp_path):
    """Op rows, a scope and the step tracer's spans in one balanced
    stream, the op rows and the spans of this thread under one tid."""
    from mxnet_tpu_torch.telemetry import trace
    trace.clear()
    trace.enable()
    try:
        mx.profiler.set_config(filename=str(tmp_path / 'm.json'),
                               profile_imperative=True)
        mx.profiler.start()
        with trace.span('step'):
            with mx.profiler.scope('inner'):
                mx.nd.dot(mx.nd.ones((4, 4)), mx.nd.ones((4, 4)))
        mx.profiler.stop()
        mx.profiler.dump()
    finally:
        trace.disable()
        trace.clear()
    with open(str(tmp_path / 'm.json')) as f:
        evs = json.load(f)['traceEvents']
    tid = trace.tid_for_current_thread()
    by_name = {e['name']: e for e in evs if e.get('ph') != 'M'}
    assert {'step', 'inner', 'dot'} <= set(by_name)
    assert by_name['dot']['tid'] == by_name['step']['tid'] == tid
    opened = [e['name'] for e in evs if e.get('ph') == 'B']
    closed = [e['name'] for e in evs if e.get('ph') == 'E']
    assert sorted(opened) == sorted(closed)


def test_port_profile_sync_times_ops_in_invoke(tmp_path):
    """Rows come from ``_imperative.invoke``: an op recorded under
    autograd gets its row too, and pause/resume gate them."""
    mx.profiler.set_config(profile_imperative=True, profile_sync=True)
    mx.profiler.start()
    x = mx.nd.array(onp.ones((2, 2), 'float32'))
    x.attach_grad()
    with mx.autograd.record():
        y = mx.nd.relu(x)
    mx.profiler.pause()
    mx.nd.exp(x)
    mx.profiler.resume()
    y.backward()
    mx.nd.tanh(x)
    mx.profiler.stop()
    names = [e['name'] for e in json.loads(
        mx.profiler.dumps(format='json'))['traceEvents']]
    assert names == ['relu', 'tanh']
