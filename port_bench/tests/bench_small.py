"""Small sizes at which the CPU tests drive each cell, and the
configuration a small cell runs (the program in float32, so that an
unbroken run is clean; the test CLI's pipeline cut to 2 clips of 32^2)."""

import os

from port_bench.lib import harness

SMALL = {
    'r50_dense': dict(video_shape=[1, 24, 48, 48, 3], pool=2, warmup=1),
    'r50_train': dict(batch_shape=[4, 8, 48, 48, 3], pool=4,
                      log_interval=1),
    # 2 videos of 80 JPEGs at 36x64; cv2 decodes on the CPU, so nvJPEG's
    # count is not checked here
    'r50_test_cli': dict(videos=2, frames=80, frame_hw=[36, 64],
                         video_shape=[1, 48, 32, 32, 3], workers=2,
                         checks={'logp_err': None}),
}


def small_cell(bench: dict, name: str):
    """(cell, config, workload) of ``name`` at its small size, with the
    cell's own limits."""
    cell = harness.cell(bench, name)
    config = harness.load_json(os.path.join(
        harness.ROOT, harness.config_entry(bench, cell['config'])['file']))
    config = dict(config, compute_dtype='float32')
    if name == 'r50_test_cli':
        ops = [dict(op) for op in config['test_pipeline']]
        for op in ops:
            if op['type'] == 'Resize':
                op['scale'] = ['inf', 32]
            if op['type'] == 'ThreeCrop':
                op['crop_size'] = 32
            if op['type'] == 'SampleFrames':
                op['num_clips'] = 2
        config['test_pipeline'] = ops
    workload = harness.workload_file(name)
    small = dict(SMALL[name])
    if 'checks' in small:
        small['checks'] = {k: workload['checks'][k] for k in small['checks']}
    return cell, config, dict(workload, **small)
