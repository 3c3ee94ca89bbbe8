"""XML artifacts of strategy trees, logical graphs and ip tables: the port of
:mod:`adapcc_tpu.strategy.xml_io` (a copy: importing the reference module
would load JAX through its package).

- strategy XML: ``<trees><root id ip><gpu id ip>…</gpu></root></trees>``
  (reference strategy/*.xml), plus the ``schema``, ``synthesis``,
  ``chunk_bytes``, ``wire_dtype`` and two-level ``hier``/``hier_pod_algo``/
  ``hier_leader_algo`` attributes the JAX package stamps;
- logical graph XML: ``<graph version><server id ip><nic id><gpu id/></nic>
  </server></graph>`` (reference topology/logical_graph_*.xml);
- ip table: one ip per line, line index = world rank.

The reference fixtures hold attribute pairs with no space between them
(``<gpu id='1'ip='…'/>``), which strict XML rejects, so parsing retries
through a lenient pre-pass.

- schedule program XML: ``<schedule schema name world chunks collective
  wire_dtype [relays]><round><step kind rank chunk [peer] [codec]/>…</round>
  </schedule>``, a ``compiler.ScheduleProgram`` step by step in program
  order, byte for byte the JAX package's text.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional
from xml.etree import ElementTree as ET

from adapcc_tpu_torch.primitives import DEFAULT_CHUNK_BYTES
from adapcc_tpu_torch.quant.codec import codec_names
from adapcc_tpu_torch.strategy.ir import Strategy, Tree

#: schema version stamped on emitted artifacts: a parser accepts any minor
#: of its own major and rejects a different major; no stamp is a reference
#: artifact and is accepted
SCHEDULE_SCHEMA_VERSION = "1.0"


def _check_schema_version(doc: ET.Element, element: str) -> None:
    """Reject an artifact stamped with a schema major this parser does not
    speak."""
    raw = doc.attrib.get("schema")
    if raw is None:
        return
    ours = SCHEDULE_SCHEMA_VERSION.split(".")[0]
    theirs = raw.split(".")[0]
    if not theirs.isdigit() or theirs != ours:
        raise ValueError(
            f"<{element} schema={raw!r}>: this build speaks schema major {ours} (version "
            f"{SCHEDULE_SCHEMA_VERSION}); refusing to parse a different major rather than "
            "silently dropping its semantics"
        )


# a closing quote directly followed by the next name='…' pair: insert the
# missing space (the lookahead needs a quote after the '=', so a value like
# ip='host=a' is left alone)
_MISSING_SPACE = re.compile(r"(['\"])(?=[A-Za-z_][\w.-]*\s*=\s*['\"])")


def _lenient_fromstring(text: str) -> ET.Element:
    try:
        return ET.fromstring(text)
    except ET.ParseError:
        return ET.fromstring(_MISSING_SPACE.sub(r"\1 ", text))


def _valid_wire_dtype(raw: str) -> str:
    """A ``wire_dtype`` attribute must name a registered codec: a corrupted
    artifact fails at the file that carries it."""
    if raw not in codec_names():
        raise ValueError(f"<trees wire_dtype={raw!r}>: expected one of {'|'.join(codec_names())}")
    return raw


def _positive_chunk(raw: str, element: str) -> int:
    """A ``chunk_bytes`` attribute must be a positive byte count."""
    try:
        value = int(raw)
    except ValueError:
        value = -1
    if value <= 0:
        raise ValueError(f"<{element} chunk_bytes={raw!r}>: expected a positive byte count")
    return value


def _maybe_read(text_or_path: str) -> str:
    if text_or_path.lstrip().startswith("<"):
        return text_or_path
    with open(text_or_path) as f:
        return f.read()


# --------------------------------------------------------------------------- #
# strategy trees
# --------------------------------------------------------------------------- #


def parse_strategy_xml(text_or_path: str, chunk_bytes: int = DEFAULT_CHUNK_BYTES) -> Strategy:
    """A strategy XML document (or a path to one) as a :class:`Strategy`.

    ``chunk_bytes`` is a default: a ``chunk_bytes`` attribute on ``<trees>``
    (and per tree on ``<root>``) wins."""
    doc = _lenient_fromstring(_maybe_read(text_or_path))
    if doc.tag != "trees":
        raise ValueError(f"expected <trees> root element, got <{doc.tag}>")
    _check_schema_version(doc, "trees")

    trees: List[Tree] = []
    all_ranks: set = set()
    per_tree_chunks: List[Optional[int]] = []
    for root_el in doc.findall("root"):
        children: Dict[int, List[int]] = {}
        ips: Dict[int, str] = {}

        def walk(el: ET.Element, parent_rank: Optional[int]) -> None:
            rank = int(el.attrib["id"])
            ips[rank] = el.attrib.get("ip", "")
            if parent_rank is not None:
                children.setdefault(parent_rank, []).append(rank)
            for sub in el.findall("gpu"):
                walk(sub, rank)

        walk(root_el, None)
        trees.append(Tree(int(root_el.attrib["id"]), children, ips))
        all_ranks |= trees[-1].ranks
        raw = root_el.attrib.get("chunk_bytes")
        per_tree_chunks.append(_positive_chunk(raw, "root") if raw else None)

    world_size = max(all_ranks) + 1 if all_ranks else 0
    doc_chunk = doc.attrib.get("chunk_bytes")
    if doc_chunk:
        chunk_bytes = _positive_chunk(doc_chunk, "trees")
    tree_chunk_bytes: Optional[List[int]] = None
    if any(c is not None for c in per_tree_chunks):
        # a tree without its own attribute pipelines at the document chunk
        tree_chunk_bytes = [c if c is not None else chunk_bytes for c in per_tree_chunks]
    raw_wire = doc.attrib.get("wire_dtype")
    strategy = Strategy(
        trees, world_size, chunk_bytes,
        synthesis=doc.attrib.get("synthesis") or None,
        tree_chunk_bytes=tree_chunk_bytes,
        wire_dtype=_valid_wire_dtype(raw_wire) if raw_wire else "off",
    )
    raw_hier = doc.attrib.get("hier")
    if raw_hier:
        # a composed two-level plan's sketch rides the artifact: reattached,
        # a parsed strategy runs the composed phases; a malformed attribute
        # fails at the file that carries it
        from adapcc_tpu_torch.strategy import hierarchy

        m = re.fullmatch(r"([1-9]\d*)x([1-9]\d*)", raw_hier)
        if not m:
            raise ValueError(f"<trees hier={raw_hier!r}>: expected '<pods>x<pod_size>'")
        hierarchy.plan_from_strategy(
            strategy,
            hierarchy.HierarchySketch(int(m.group(1)), int(m.group(2))),
            doc.attrib.get("hier_pod_algo", "rs-ag"),
            doc.attrib.get("hier_leader_algo", "tree"),
        )
    return strategy


def emit_strategy_xml(strategy: Strategy, path: Optional[str] = None) -> str:
    """A :class:`Strategy` in the reference XML schema, with the schema,
    provenance, chunk and codec attributes that make it self-contained."""
    doc = ET.Element("trees")
    doc.set("schema", SCHEDULE_SCHEMA_VERSION)
    if strategy.synthesis:
        doc.set("synthesis", strategy.synthesis)
    doc.set("chunk_bytes", str(strategy.chunk_bytes))
    plan = getattr(strategy, "_two_level_plan", None)
    if plan is not None:
        # the composed plan's sketch and level schedules: a re-parsed
        # strategy runs the same phases
        doc.set("hier", f"{plan.sketch.num_pods}x{plan.sketch.pod_size}")
        doc.set("hier_pod_algo", plan.pod_algo)
        doc.set("hier_leader_algo", plan.leader_algo)
    if strategy.wire_dtype != "off":
        # only a codec is persisted: absence means "off"
        doc.set("wire_dtype", strategy.wire_dtype)
    for i, tree in enumerate(strategy.trees):
        def build(rank: int, parent_el: ET.Element, tag: str) -> None:
            el = ET.SubElement(parent_el, tag)
            el.set("id", str(rank))
            el.set("ip", tree.ips.get(rank, ""))
            if tag == "root" and strategy.tree_chunk_bytes is not None:
                el.set("chunk_bytes", str(strategy.tree_chunk_bytes[i]))
            for c in tree.children.get(rank, ()):
                build(c, el, "gpu")

        build(tree.root, doc, "root")
    text = ET.tostring(doc, encoding="unicode")
    if path:
        with open(path, "w") as f:
            f.write(text)
    return text


# --------------------------------------------------------------------------- #
# schedule programs (the compiler IR's artifact)
# --------------------------------------------------------------------------- #


def emit_program_xml(program, path: Optional[str] = None) -> str:
    """A ``compiler.ScheduleProgram`` as its XML artifact: one ``<round>`` a
    round and one ``<step>`` a step, in program order (the order inside a
    round fixes the combine order, hence the bits), so
    :func:`parse_program_xml` gives back an equal fingerprint."""
    doc = ET.Element("schedule")
    doc.set("schema", SCHEDULE_SCHEMA_VERSION)
    doc.set("name", program.name)
    doc.set("world", str(program.world))
    doc.set("chunks", str(program.chunks))
    doc.set("collective", program.collective)
    doc.set("wire_dtype", program.wire_dtype)
    if program.relays:
        doc.set("relays", ",".join(str(r) for r in program.relays))
    for round_steps in program.rounds:
        round_el = ET.SubElement(doc, "round")
        for step in round_steps:
            el = ET.SubElement(round_el, "step")
            el.set("kind", step.kind)
            el.set("rank", str(step.rank))
            el.set("chunk", str(step.chunk))
            if step.peer is not None:
                el.set("peer", str(step.peer))
            if step.codec is not None:
                el.set("codec", step.codec)
    text = ET.tostring(doc, encoding="unicode")
    if path:
        with open(path, "w") as f:
            f.write(text)
    return text


def parse_program_xml(text_or_path: str):
    """A schedule-program artifact (text or path) back into a
    ``compiler.ScheduleProgram``.  A different schema major raises; the
    program's own checks then bound every rank and chunk."""
    from adapcc_tpu_torch.compiler.ir import ScheduleProgram, Step

    text = _maybe_read(text_or_path)
    doc = _lenient_fromstring(text)
    if doc.tag != "schedule":
        raise ValueError(f"expected <schedule> root element, got <{doc.tag}>")
    _check_schema_version(doc, "schedule")
    try:
        world = int(doc.attrib["world"])
        chunks = int(doc.attrib["chunks"])
    except (KeyError, ValueError) as e:
        raise ValueError(f"<schedule>: bad or missing world/chunks attribute: {e}")
    raw_relays = doc.attrib.get("relays", "")
    relays = tuple(int(r) for r in raw_relays.split(",") if r.strip()) if raw_relays else ()
    rounds = []
    for round_el in doc.findall("round"):
        steps = []
        for el in round_el.findall("step"):
            peer = el.attrib.get("peer")
            steps.append(Step(el.attrib["kind"], int(el.attrib["rank"]), int(el.attrib["chunk"]),
                              peer=int(peer) if peer is not None else None, codec=el.attrib.get("codec")))
        rounds.append(tuple(steps))
    return ScheduleProgram(
        name=doc.attrib.get("name", "parsed"),
        world=world,
        chunks=chunks,
        rounds=tuple(rounds),
        collective=doc.attrib.get("collective", "allreduce"),
        wire_dtype=doc.attrib.get("wire_dtype", "off"),
        relays=relays,
    )


# --------------------------------------------------------------------------- #
# logical graph
# --------------------------------------------------------------------------- #


@dataclass
class LogicalGraph:
    """Cluster sketch: which ranks live on which server behind which nic."""

    servers: List["ServerEntry"] = field(default_factory=list)
    version: str = "adapcc-tpu"

    def rank_to_ip(self) -> Dict[int, str]:
        return {g: s.ip for s in self.servers for g in s.gpus}

    def local_rank0_list(self) -> List[int]:
        return [min(s.gpus) for s in self.servers if s.gpus]

    @property
    def world_size(self) -> int:
        return sum(len(s.gpus) for s in self.servers)


@dataclass
class ServerEntry:
    server_id: int
    ip: str
    nic_id: int
    gpus: List[int] = field(default_factory=list)


def parse_logical_graph_xml(text_or_path: str) -> LogicalGraph:
    doc = _lenient_fromstring(_maybe_read(text_or_path))
    if doc.tag != "graph":
        raise ValueError(f"expected <graph> root element, got <{doc.tag}>")
    graph = LogicalGraph(version=doc.attrib.get("version", ""))
    for server_el in doc.findall("server"):
        sid = int(server_el.attrib["id"])
        ip = server_el.attrib.get("ip", "")
        for nic_el in server_el.findall("nic"):
            entry = ServerEntry(sid, ip, int(nic_el.attrib.get("id", 0)))
            entry.gpus.extend(int(g.attrib["id"]) for g in nic_el.findall("gpu"))
            graph.servers.append(entry)
    return graph


def emit_logical_graph_xml(graph: LogicalGraph, path: Optional[str] = None) -> str:
    doc = ET.Element("graph")
    doc.set("version", graph.version)
    for s in graph.servers:
        server_el = ET.SubElement(doc, "server")
        server_el.set("id", str(s.server_id))
        server_el.set("ip", s.ip)
        nic_el = ET.SubElement(server_el, "nic")
        nic_el.set("id", str(s.nic_id))
        for g in s.gpus:
            ET.SubElement(nic_el, "gpu").set("id", str(g))
    text = ET.tostring(doc, encoding="unicode")
    if path:
        with open(path, "w") as f:
            f.write(text)
    return text


# --------------------------------------------------------------------------- #
# ip table
# --------------------------------------------------------------------------- #


def read_ip_table(path: str) -> List[str]:
    """Rank→ip list; the line index is the world rank."""
    with open(path) as f:
        return [line.strip() for line in f if line.strip()]


def write_ip_table(ips: List[str], path: str) -> None:
    with open(path, "w") as f:
        for ip in ips:
            f.write(ip + "\n")
