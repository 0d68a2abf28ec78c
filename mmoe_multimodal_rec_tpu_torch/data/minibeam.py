"""In-process, single-host executor for the Beam API surface the feature
pipeline uses.

The reference ships feature engineering as an Apache Beam/Dataflow job
(data4moe_beam.py:322-435).  This repo's adapter (data/beam_pipeline.py)
builds that same DAG against whatever module provides the Beam API; this
module provides it EAGERLY — a PCollection is a materialized list and every
transform applies at pipe time.  Eager execution is semantically equivalent
here because the pipeline is a finite bounded batch job with no
windowing/triggers: the dataflow order of a bounded DAG is exactly its
topological (construction) order.

Why it exists:
  * the adapter's DAG construction and DoFns can EXECUTE — and be tested
    row-identical to features.run_feature_pipeline — in environments without
    apache_beam;
  * a zero-dependency local runner for smoke-testing pipeline changes before
    a Dataflow submit.

Deliberately NOT implemented (use real Beam): streaming/windowing/triggers,
multi-worker execution, metrics, state/timers, coders.  Only the surface
beam_pipeline.py touches is provided; unknown attributes raise AttributeError
at construction time, not silently at "run" time.

The PyTorch port's own copy of mmoe_multimodal_rec_tpu/data/minibeam.py.
"""
from __future__ import annotations

import random
from typing import Any, Callable, Iterable, List


class PCollection:
    """A materialized collection; `pcoll | transform` applies eagerly."""

    def __init__(self, items: Iterable[Any]):
        self.items: List[Any] = list(items)

    def __or__(self, transform: "PTransform") -> "PCollection":
        return transform.expand(self)


class pvalue:
    """Side-input markers (beam.pvalue.AsDict/AsList equivalents)."""

    class AsDict:
        def __init__(self, pcoll: PCollection):
            self.pcoll = pcoll

    class AsList:
        def __init__(self, pcoll: PCollection):
            self.pcoll = pcoll

    class AsSingleton:
        def __init__(self, pcoll: PCollection):
            self.pcoll = pcoll


def _resolve(side: Any) -> Any:
    """Side inputs resolve at apply time — legal because PCollections are
    already materialized when a downstream transform references them."""
    if isinstance(side, pvalue.AsDict):
        return dict(side.pcoll.items)
    if isinstance(side, pvalue.AsList):
        return list(side.pcoll.items)
    if isinstance(side, pvalue.AsSingleton):
        (item,) = side.pcoll.items
        return item
    return side


class PTransform:
    def __rrshift__(self, label: str) -> "PTransform":
        # "Label" >> transform : labels are display-only in beam; keep for
        # error messages.
        self.label = label
        return self

    def expand(self, pcoll: PCollection) -> PCollection:
        raise NotImplementedError


class DoFn:
    """Minimal DoFn: setup() once per transform application, process() per
    element (side inputs resolved positionally), teardown() at the end."""

    def setup(self):  # pragma: no cover - default no-op
        pass

    def teardown(self):  # pragma: no cover - default no-op
        pass

    def process(self, element, *side_inputs):
        raise NotImplementedError


class ParDo(PTransform):
    def __init__(self, fn: DoFn, *sides: Any):
        self.fn, self.sides = fn, sides

    def expand(self, pcoll: PCollection) -> PCollection:
        sides = [_resolve(s) for s in self.sides]
        out: List[Any] = []
        self.fn.setup()
        try:
            for el in pcoll.items:
                res = self.fn.process(el, *sides)
                if res is not None:
                    out.extend(res)
        finally:
            self.fn.teardown()
        return PCollection(out)


class Map(PTransform):
    def __init__(self, fn: Callable, *sides: Any):
        self.fn, self.sides = fn, sides

    def expand(self, pcoll: PCollection) -> PCollection:
        sides = [_resolve(s) for s in self.sides]
        return PCollection(self.fn(el, *sides) for el in pcoll.items)


class FlatMap(PTransform):
    def __init__(self, fn: Callable, *sides: Any):
        self.fn, self.sides = fn, sides

    def expand(self, pcoll: PCollection) -> PCollection:
        sides = [_resolve(s) for s in self.sides]
        out: List[Any] = []
        for el in pcoll.items:
            out.extend(self.fn(el, *sides))
        return PCollection(out)


class Filter(PTransform):
    def __init__(self, pred: Callable[[Any], bool]):
        self.pred = pred

    def expand(self, pcoll: PCollection) -> PCollection:
        return PCollection(el for el in pcoll.items if self.pred(el))


class WithKeys(PTransform):
    def __init__(self, key_fn: Callable):
        self.key_fn = key_fn

    def expand(self, pcoll: PCollection) -> PCollection:
        fn = self.key_fn if callable(self.key_fn) else (
            lambda _el, k=self.key_fn: k)
        return PCollection((fn(el), el) for el in pcoll.items)


class Keys(PTransform):
    def expand(self, pcoll: PCollection) -> PCollection:
        return PCollection(k for k, _ in pcoll.items)


class GroupByKey(PTransform):
    def expand(self, pcoll: PCollection) -> PCollection:
        groups: dict = {}
        for k, v in pcoll.items:
            groups.setdefault(k, []).append(v)
        return PCollection(groups.items())


class MapTuple(PTransform):
    def __init__(self, fn: Callable):
        self.fn = fn

    def expand(self, pcoll: PCollection) -> PCollection:
        return PCollection(self.fn(*el) for el in pcoll.items)


class Create(PTransform):
    def __init__(self, items: Iterable[Any]):
        self.items = items

    def expand(self, _root) -> PCollection:
        return PCollection(self.items)


class combiners:
    class Sample:
        @staticmethod
        def FixedSizeGlobally(n: int) -> PTransform:
            return _FixedSizeSample(n)


class _FixedSizeSample(PTransform):
    """Single-element PCollection holding a <=n-item sample.  Beam samples
    via per-element random keys; with everything local a seeded
    random.sample gives the same uniform-without-replacement semantics,
    reproducibly."""

    def __init__(self, n: int):
        self.n = n

    def expand(self, pcoll: PCollection) -> PCollection:
        items = pcoll.items
        if len(items) > self.n:
            items = random.Random(0).sample(items, self.n)
        return PCollection([list(items)])


class _Result:
    def wait_until_finish(self):  # everything already ran eagerly
        return "DONE"


class Pipeline:
    """Root object; `pipeline | Create([...])` mints a PCollection.  Usable
    as a context manager like beam.Pipeline (run() is a no-op — eager)."""

    def __or__(self, transform: PTransform) -> PCollection:
        return transform.expand(self)

    def run(self) -> _Result:
        return _Result()

    def __enter__(self) -> "Pipeline":
        return self

    def __exit__(self, *exc) -> None:
        return None
