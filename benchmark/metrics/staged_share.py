"""The share of the pair table's rows the compositors still move, in
percent: 100 x the sum of the `staged` counter of the window's `composite`
spans (the rows K2 staged through their gids) and `backward.raster` spans
(K3's, in a train step) over the sum of the `rows` counter of the window's
`gather` spans (the gid table's length: the rows a gathered pair table
held). A program whose compositors count no staged rows gives None."""

from benchmark import spans


def read(run):
    rows = staged = 0
    for s in spans.window(run, "gather"):
        if "rows" not in s.counters:
            return None
        rows += int(s.counters["rows"])
    composite = spans.window(run, "composite")
    if not composite:
        return None
    for s in composite + spans.window(run, "backward.raster"):
        if "staged" not in s.counters:
            return None
        staged += int(s.counters["staged"])
    return 100.0 * staged / rows if rows else None
