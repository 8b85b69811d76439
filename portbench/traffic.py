"""The one generator of every cell's inputs: a configuration's dictionary
and a traffic mix's text, both from ``--seed``.

The seed feeds independent streams (``numpy.random.SeedSequence``): the
corpus, the dictionary where its configuration fixes no seed of its own,
the planting's order and places, and the sample of outputs compared. What
is planted, and a dictionary with its own seed, are the same for every
seed, so that every seed gives the same work in another order. What a mix
may ask for is the data in ``traffic/<name>.json``: a base corpus recipe
and at most one plant.
"""

from __future__ import annotations

from . import recipes

CORPUS, DICTIONARY, PLANT, SAMPLE = 1, 2, 3, 4


def stream(seed: int, which: int) -> list:
    return [int(seed), which]


def dictionary(config: dict, seed: int) -> list:
    d = config["dictionary"]
    if d["kind"] == "random_words":
        draw = d["seed"] if "seed" in d else stream(seed, DICTIONARY)
        return recipes.many_words(d["count"], draw, tuple(d["length"]), d["letters"])
    if d["kind"] == "list":
        return list(d["words"])
    raise ValueError(f"dictionary kind {d['kind']!r}")


def text(traffic: dict, words: list, seed: int, scale: float = 1.0) -> str:
    """The mix's text for the dictionary ``words``; ``scale`` shrinks the
    corpus and the plant counts alike (the CPU tests only)."""
    c = traffic["corpus"]
    if c["recipe"] != "lorem":
        raise ValueError(f"corpus recipe {c['recipe']!r}")
    size = max(1 << 12, int(c["bytes"] * scale))
    out = recipes.build_corpus(size, stream(seed, CORPUS), c["filler"], c["needles"],
                               c["needle_one_in"])
    plant = traffic.get("plant")
    if not plant:
        return out
    count = max(1, int(plant["count"] * scale))
    if plant["kind"] == "third_letter_typos":
        return recipes.many_corpus(out, words, count, plant["min_length"], stream(seed, PLANT))
    if plant["kind"] == "edited_copies":
        return recipes.plant_phrases(out, stream(seed, PLANT), count, words,
                                     tuple(plant["edits"]), tuple(plant["rewrite"]),
                                     plant["rewrite_every"], plant.get("set_seed"))[0]
    raise ValueError(f"plant kind {plant['kind']!r}")
