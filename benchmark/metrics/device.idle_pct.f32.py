"""device.idle_pct.f32: device.idle_pct (metrics/device.idle_pct.py) in the float32 cells, whose runs spread
wider than the float64 cells' (their host phases weigh more), so that
the end-to-end metric it feeds carries a bound of its own."""

from harness import manifest

read = manifest.reader("device.idle_pct").read
