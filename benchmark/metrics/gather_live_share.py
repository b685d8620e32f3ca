"""The share of the rows the gather reads that are a tile's pairs, in
percent: 100 x the sum of the `live` counter over the sum of the `rows`
counter of the window's `gather` spans of the program (rows: the gid
table's length, the kept or sat budget; live: the pairs in it that are not
the null row)."""

from benchmark import spans


def read(run):
    rows = live = 0
    for s in spans.window(run, "gather"):
        if "rows" not in s.counters or "live" not in s.counters:
            return None
        rows += int(s.counters["rows"])
        live += int(s.counters["live"])
    return 100.0 * live / rows if rows else None
