"""Host milliseconds an image inside ``cli/tiled.py`` ``tiled_reverse`` outside its
``reverse_fn`` calls: the tile plan, padding, stacking and the blend."""

UNIT, BETTER, SOURCE = "ms", "lower", "host_clock"
LAYER = "serving CLI tiling"
MOVES = "hr_mps.tiled"
WORKLOADS = ["sr_x4_f32.tiles"]


def read(r):
    tiled = r.host_s("bench.tiled")
    if not tiled or not r.requests:
        return None
    return 1e3 * (tiled - r.host_s("bench.reverse_fn")) / r.requests
