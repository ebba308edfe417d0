"""A pytest plugin that repeats tests in one session: the collected items
whose node id contains ``REPEAT_MATCH`` run ``REPEAT_N`` times, as one
block in their place (file order kept), so a test that fails now and then
meets the state its neighbours leave, again and again.  Repeat r of an
item has the node id ``<id>#<r>``, so the repeats also run under
``pytest-xdist`` (``-n 6 --dist loadfile`` keeps them in their file's
worker).

    REPEAT_N=50 REPEAT_MATCH=test_torch_rglru_scan.py \\
        PYTHONPATH=src:tools python -m pytest -p pytest_repeat tests/test_torch_rglru_scan.py
"""
import copy
import os


def _repeat(item, r):
    new = copy.copy(item)
    new._nodeid = f"{item.nodeid}#{r}"
    new._initrequest()
    return new


def pytest_collection_modifyitems(session, config, items):
    n = int(os.environ.get("REPEAT_N", "1"))
    pat = os.environ.get("REPEAT_MATCH", "")
    if n <= 1 or not pat:
        return
    hit = [i for i, it in enumerate(items) if pat in it.nodeid]
    if not hit:
        return
    block = [items[i] for i in hit]
    rest = [it for i, it in enumerate(items) if i not in set(hit)]
    repeats = [it if r == 0 else _repeat(it, r) for r in range(n) for it in block]
    items[:] = rest[:hit[0]] + repeats + rest[hit[0]:]
