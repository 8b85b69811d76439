"""The readers of the port's own spans and wait counter (``host_waits``,
``prepare_ms``, ``host_wait_ms``) on a hand-made ``trace.stats``: medians
over the searches that reported them, None where none did (a tree whose
port records no span, as before ``utils/trace``)."""

from pathlib import Path
from types import SimpleNamespace

import pytest

from portbench import manifest

ROOT = Path(__file__).resolve().parents[2]
CELLS = ["dict1k-e1.typos96", "ocr-names-e4.copies96", "dict1k-e1.clean96"]


def _read(metric, stats):
    return manifest.Manifest(ROOT).reader(metric)(SimpleNamespace(stats=stats, searches=len(stats)))


def test_medians_over_the_searches():
    stats = [
        {"backend": "device-fuzzy-dp-mapped", "host_waits": 18, "prepare_us": 412.5,
         "host_wait_us": 2250.0},
        {"backend": "device-fuzzy-dp-mapped", "host_waits": 18, "prepare_us": 380.25,
         "host_wait_us": 1975.5},
        {"backend": "device-fuzzy-dp-mapped", "host_waits": 19, "prepare_us": 1204.0,
         "host_wait_us": 2600.0},
        # The untraced warm-up's keys alone: counted, no spans.
        {"backend": "device-fuzzy-dp-mapped", "host_waits": 20},
    ]
    assert _read("host_waits", stats) == 18.5
    assert _read("prepare_ms", stats) == pytest.approx(0.4125)
    assert _read("host_wait_ms", stats) == pytest.approx(2.25)


def test_none_where_no_search_reported():
    parent = [{"backend": "device-fuzzy-many", "hits": 5531, "dispatch_ms": 6.9,
               "decode_ms": 3.2}] * 3
    for metric in ("host_waits", "prepare_ms", "host_wait_ms"):
        assert _read(metric, parent) is None
        assert _read(metric, []) is None


def test_entries_list_every_cell():
    man = manifest.Manifest(ROOT)
    got = {m["name"]: m for m in man.bench["per_layer"]}
    for metric, unit, source, layer in (
            ("host_waits", "waits", "program_counter", "lane device stage"),
            ("prepare_ms", "ms", "program_span", "dispatch"),
            ("host_wait_ms", "ms", "program_span", "lane device stage")):
        m = got[metric]
        assert (m["unit"], m["source"], m["layer"], m["better"]) == (unit, source, layer, "lower")
        assert m["moves"] == "search_MBps" and m["workloads"] == CELLS
        for cell in CELLS:
            assert metric in [x["name"] for x in man.per_layer(cell)]
