"""BENCHMARK.json against the benchmark's contract: names and units, every
piece found by name, each per-layer metric's cells reporting the
end-to-end metric it moves, one chip a cell."""

import json
import os
import re

import pytest
from conftest import ROOT

NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')
KEYS = {
    'top': {'command', 'paths', 'run_seconds', 'configs', 'workloads',
            'end_to_end', 'per_layer'},
    'config': {'name', 'source', 'file', 'reduced', 'why'},
    'workload': {'name', 'config', 'traffic', 'chips', 'why'},
    'end_to_end': {'name', 'unit', 'better', 'bound', 'source'},
    'per_layer': {'name', 'unit', 'better', 'source', 'layer', 'moves'},
}


@pytest.fixture(scope='module')
def bench():
    with open(os.path.join(ROOT, 'BENCHMARK.json')) as fh:
        return json.load(fh)


def _line(s):
    return 1 <= len(s) <= 200 and '\n' not in s and '\t' not in s


def test_keys_names_units(bench):
    assert set(bench) == KEYS['top']
    names = []
    for kind, key in (('config', 'configs'), ('workload', 'workloads'),
                      ('end_to_end', 'end_to_end'),
                      ('per_layer', 'per_layer')):
        for e in bench[key]:
            assert set(e) - {'workloads'} == KEYS[kind], e
            assert NAME.match(e['name']), e['name']
            if 'unit' in e:
                assert UNIT.match(e['unit']), e['unit']
                assert e['better'] in ('lower', 'higher')
            names.append((key, e['name']))
    assert len(set(names)) == len(names)
    for c in bench['configs']:
        assert all(NAME.match(k) for k in c['reduced'])
        assert _line(c['why']) and _line(c['source'])
    for w in bench['workloads']:
        assert NAME.match(w['config']) and NAME.match(w['traffic'])
        assert _line(w['why'])
    for m in bench['per_layer']:
        assert _line(m['layer'])
    assert all(_line(word) for word in bench['command'])
    assert 1 <= bench['run_seconds'] <= 51


def test_pieces_found_by_name(bench):
    from portbench.harness import manifest
    for c in bench['configs']:
        path = os.path.join(ROOT, c['file'])
        assert c['file'].startswith('portbench/') and os.path.exists(path)
        with open(path) as fh:
            assert json.load(fh)['name'] == c['name']
    for w in bench['workloads']:
        cell = manifest.cell(w['name'], bench)
        assert os.path.exists(os.path.join(
            ROOT, 'portbench', 'traffic', f"{w['traffic']}.json"))
        lim = manifest.limits(w['name'])
        nums = {k: v for k, v in lim.items() if k != 'readings'}
        assert nums and all(0 < v < 1 for v in nums.values())
        for k, v in nums.items():
            r = lim['readings'][k]
            assert r['lower'] < v < r['upper'], (w['name'], k)
        assert cell['per_layer'], w['name']
    for m in bench['per_layer']:
        assert callable(manifest.reader(m['name']))


def test_cells_report_what_they_move(bench):
    e2e = {m['name']: m for m in bench['end_to_end']}
    cells = [w['name'] for w in bench['workloads']]
    assert 'setup_s' in e2e

    def reports(metric, cell):
        return cell in e2e[metric].get('workloads', cells)

    for cell in cells:
        assert reports('setup_s', cell)
        assert any(reports(m, cell) for m in e2e if m != 'setup_s')
    for m in bench['per_layer']:
        assert m['moves'] in e2e
        for cell in m.get('workloads', cells):
            assert cell in cells and reports(m['moves'], cell), (m, cell)
    for cell in cells:
        assert any(cell in m.get('workloads', cells)
                   for m in bench['per_layer'])


def test_chips_and_bounds(bench):
    assert all(w['chips'] == 1 for w in bench['workloads'])
    for m in bench['end_to_end']:
        assert 0.01 <= m['bound'] <= 0.25
        assert m['source'] in ('host_clock', 'device_trace')
    for m in bench['per_layer']:
        assert m['source'] in ('device_trace', 'program_span',
                               'program_counter', 'host_clock')
