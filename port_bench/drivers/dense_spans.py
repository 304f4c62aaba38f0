"""Dense-test driver with the model's own spans read from the device trace.

The requests, window, check and traced readings of ``dense.Bench``, and,
in a traced run, one more stretch of ``profiled_requests`` requests under
``lib.spans.profile`` (spans on, torch.profiler on): the device time of
the work launched inside the program's ``model.stem`` and ``model.norm``
spans, and the growth of its ``BatchNorm.counts['forward']``, each a
video. Each reads None where the program has no such span or counter.
"""

from __future__ import annotations

from typing import Optional

from port_bench.drivers import dense
from port_bench.lib import spans


def norm_forwards() -> Optional[int]:
    """The program's count of ``BatchNorm`` forwards, or None where it
    keeps none."""
    from mvfnet_tpu_torch.models.common import BatchNorm
    counts = getattr(BatchNorm, 'counts', None)
    return None if counts is None else counts['forward']


class Bench(dense.Bench):
    def span_readings(self) -> dict:
        """``profiled_requests`` requests with spans on under the
        profiler; the three readings a video."""
        k = self.workload['profiled_requests']
        before = norm_forwards()
        prof = spans.profile(lambda: self._serve(count=k))
        after = norm_forwards()

        def per_video(ms):
            return None if ms is None else ms / k
        return dict(
            stem_device_ms=per_video(spans.device_ms_within(prof,
                                                            'model.stem')),
            norm_device_ms=per_video(spans.device_ms_within(prof,
                                                            'model.norm')),
            unfolded_norms=(None if before is None or after is None
                            else (after - before) / k))

    def traced(self, seconds: float) -> dict:
        data = super().traced(seconds)
        data.update(self.span_readings())
        return data
