"""The manifest finds a configuration, a traffic mix, a per-layer metric
and a cell that are added as new files and entries, with no file that is
already there edited."""

import hashlib
import json
import shutil
from pathlib import Path

from portbench import manifest, recipes, traffic

ROOT = Path(__file__).resolve().parents[2]


def _digests(root: Path) -> dict:
    return {p.relative_to(root).as_posix(): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_new_files_and_entries_add_a_cell(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _digests(tmp_path)
    pb = tmp_path / "portbench"
    (pb / "configs" / "dict64-e1.json").write_text(json.dumps({
        "name": "dict64-e1", "source": "test", "guarantee": "exact",
        "dictionary": {"kind": "random_words", "count": 64, "length": [7, 9],
                       "letters": "abcdefghijklmnopqrstuvwxyz"},
        "limits": {"edits": 1}, "case_insensitive": True, "threshold": 0.8, "mappings": [],
        "lane": "device-fuzzy-dp", "changed": {}, "assumed": [], "reduced": []}))
    (pb / "traffic" / "typos1.json").write_text(json.dumps({
        "why": "test", "corpus": {"recipe": "lorem", "bytes": 1 << 16, "filler": ["lorem", "ipsum"],
                                  "needles": ["dolor"], "needle_one_in": 97},
        "plant": {"kind": "third_letter_typos", "count": 8, "min_length": 7}}))
    (pb / "metrics" / "searches_traced.py").write_text("def read(trace):\n    return trace.searches\n")
    # The new entries: appended, the old ones left as they are.
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "dict64-e1", "source": "test",
                             "file": "portbench/configs/dict64-e1.json", "reduced": [],
                             "why": "test"})
    bench["workloads"].append({"name": "dict64-e1.typos1", "config": "dict64-e1",
                               "traffic": "typos1", "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "searches_traced", "unit": "searches", "better": "higher",
                               "source": "program_counter", "layer": "dispatch",
                               "moves": "search_MBps",
                               "workloads": ["dict64-e1.typos1", "dict1k-e1.typos96"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    after = _digests(tmp_path)
    assert all(after[k] == v for k, v in before.items() if k != "BENCHMARK.json")

    man = manifest.Manifest(tmp_path)
    cell = man.cell("dict64-e1.typos1")
    config = man.config(cell["config"])
    words = traffic.dictionary(config, 5)
    assert len(words) <= 64 and all(7 <= len(w) < 9 for w in words)
    text = traffic.text(man.traffic(cell["traffic"]), words, 5)
    assert len(text) == 1 << 16 and sum(w[:2] + "x" in text for w in words) > 0
    # The new metric is read in the cells it lists, the new one and an old one.
    for name in ("dict64-e1.typos1", "dict1k-e1.typos96"):
        assert "searches_traced" in [m["name"] for m in man.per_layer(name)]
    assert "searches_traced" not in [m["name"] for m in man.per_layer("dict1k-e1.clean96")]
    assert man.reader("searches_traced")(type("T", (), {"searches": 7})()) == 7
    # The existing cells resolve as before.
    assert manifest.Manifest(ROOT).per_layer("dict1k-e1.clean96") == [
        m for m in man.per_layer("dict1k-e1.clean96") if m["name"] != "searches_traced"]


def test_every_cell_resolves():
    man = manifest.Manifest(ROOT)
    for w in man.bench["workloads"]:
        assert man.config(w["config"])["name"] == w["config"]
        assert man.traffic(w["traffic"])["corpus"]["bytes"] == 96 << 20
        assert {m["name"] for m in man.end_to_end(w["name"])} >= {"setup_s", "search_MBps"}
        for m in man.per_layer(w["name"]):
            assert callable(man.reader(m["name"]))


def test_seed_gives_the_same_inputs_and_the_same_work():
    man = manifest.Manifest(ROOT)
    config = man.config("dict1k-e1")
    words = traffic.dictionary(config, 2**31 + 7)
    assert words == traffic.dictionary(config, 2**31 + 8) and 990 <= len(words) <= 1000
    mix = man.traffic("copies96")
    names = traffic.dictionary(man.config("ocr-names-e4"), 1)
    a = traffic.text(mix, names, 9, 1 / 1024)
    assert a == traffic.text(mix, names, 9, 1 / 1024) != traffic.text(mix, names, 10, 1 / 1024)
    # Another seed plants the same typos in another order: a whole cycle of
    # the long words here, 32 in the 96 MiB mix.
    base = recipes.build_corpus(1 << 20, 1, ["lorem", "ipsum"], ["dolor"], 97)
    n = sum(len(w) >= 9 for w in words)
    t1, t2 = (recipes.many_corpus(base, words, n, 9, traffic.stream(s, traffic.PLANT))
              for s in (3, 4))
    planted = lambda t: sorted(w for w in t.split(" ") if len(w) >= 9 and w[2] in "xy")
    assert t1 != t2 and planted(t1) == planted(t2) and len(planted(t1)) == n
