"""``graph_share.gen`` (``metrics/graph_share.gen.py``) in the cells of the
``fid_saln`` driver: the share of the window's scales whose block stack was
replayed from a CUDA graph, the proof that the cell's normal path replays."""

from benchmark.metrics._reuse import reader

_gen = reader("graph_share.gen")
LAYER, UNIT, BETTER, SOURCE, MOVES = (_gen.LAYER, _gen.UNIT, _gen.BETTER,
                                      _gen.SOURCE, _gen.MOVES)
DRIVERS = ("fid_saln",)
read = _gen.read
