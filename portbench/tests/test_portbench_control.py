"""On the card, at each cell's own size: the program's readings sit under
the cell's limits and the control's -- the reference with TF32 matmuls,
the nearest precision below the configuration's float32, in the
program's place -- exceed at least one of them."""

import pytest
from conftest import ROOT

from portbench.harness import manifest, md, train, traffic

CELLS = [w['name'] for w in manifest.load_manifest(ROOT)['workloads']]


@pytest.mark.cuda
@pytest.mark.parametrize('workload', CELLS)
def test_control_fails_where_the_program_passes(cuda, workload):
    cell = manifest.cell(workload, manifest.load_manifest(ROOT))
    mix = traffic.load(cell['workload']['traffic'])
    lim = manifest.limits(workload)
    if mix['kind'] == 'train':
        got = train.calibrate(cell, mix, 97, cuda, ROOT)
    else:
        got = md.calibrate(cell, mix, 97, 1.0, cuda, ROOT)
    assert all(v <= lim[k] for k, v in got['program'].items()), got
    assert any(v > lim[k] for k, v in got['control'].items()), got
