"""Nexmark's bid stream, generated from a seed, and the Flink COMPILE PLANs
of the streaming paths (the port's own generator: nothing is downloaded).

Source of the parameters: Apache Beam's NEXMark suite
(sdks/java/testing/nexmark), `NexmarkConfiguration`'s defaults
(firstEventRate 10,000 events a second, hotAuctionRatio 2,
hotBiddersRatio 4, numInFlightAuctions 100, numActivePeople 1,000,
avgBidByteSize 100, the person:auction:bid proportions 1:3:46) and
`BidGenerator`'s rules:

  * the auction: with probability 1 - 1/hotAuctionRatio (one half) the
    hot auction, the first of the last `hotAuctionRatio` auctions
    opened; else one of the `numInFlightAuctions` latest (plus Beam's
    lead of 10 not yet opened);
  * the bidder: with probability 1 - 1/hotBiddersRatio the hot bidder,
    the second of the last `hotBiddersRatio` people; else one of the
    `numActivePeople` latest (plus a lead of 10);
  * the price: `PriceGenerator.nextPrice`, round(10^(6u) x 100) cents,
    u uniform in [0, 1);
  * the channel: one of Beam's four hot channels half of the time, else
    `channel-<k>` of 10,000 with its URL;
  * `extra`: Beam's `nextExtra` padding towards avgBidByteSize (the Bid's
    four 8-byte fields counted): 54-81 letters.

Auction and person ids follow Beam's event-id arithmetic, bid i being
the i-th bid event of Beam's 50-event cycle (ids from 1,000).  Bids only:
the stream carries Nexmark's seven bid columns, `auction`, `bidder`,
`price` (BIGINT), `channel`, `url`, `dateTime` and `extra`, one JSON
object a record.  `dateTime` is the engine's timestamp_us (Flink's
TIMESTAMP(3) converts to it, convert/flink.py `type_from_flink`): bid i
at 2015-07-15 00:00:00 UTC + i x 100 us, 10,000 bids a second; the Kafka
record's timestamp is the same instant in ms.  The records are dealt
round-robin over 4 Kafka partitions (bid i to partition i % 4 at offset
i // 4), each monotone in event time.  The numpy generator (not Java's
Random) makes the draws, so the stream is Beam's in distribution, not bit
for bit.

The plans are in Flink's serialized COMPILE PLAN form (nodes, edges,
`internalName` calls), as tests/test_convert_flink.py builds them:
`q2_plan` (Nexmark q2), `q17_plan` (a reduced Nexmark q17) and
`calc_plan` (the projection of `auction` and `price` that the windowed
stream of itest/streaming.py reads).
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Dict, List

import numpy as np

from blaze_tpu_torch.ops.kafka import KafkaRecord

FIRST_EVENT_RATE = 10_000       # events a second
HOT_AUCTION_RATIO = 2
HOT_BIDDERS_RATIO = 4
NUM_IN_FLIGHT_AUCTIONS = 100
NUM_ACTIVE_PEOPLE = 1_000
AVG_BID_BYTE_SIZE = 100
PERSON_PROPORTION, AUCTION_PROPORTION, BID_PROPORTION = 1, 3, 46
FIRST_AUCTION_ID = FIRST_PERSON_ID = 1_000
AUCTION_ID_LEAD = PERSON_ID_LEAD = 10
HOT_CHANNELS = ("Google", "Facebook", "Baidu", "Apple")
CHANNELS_NUMBER = 10_000
BASE_TIME_MS = 1_436_918_400_000  # 2015-07-15 00:00:00 UTC
N_PARTITIONS = 4
TOPIC = "nexmark-bid"

#: Flink's bid table: the columns and their Flink types
BID_COLUMNS = (("auction", "BIGINT"), ("bidder", "BIGINT"),
               ("price", "BIGINT"), ("channel", "VARCHAR(2147483647)"),
               ("url", "VARCHAR(2147483647)"), ("dateTime", "TIMESTAMP(3)"),
               ("extra", "VARCHAR(2147483647)"))

_LETTERS = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz", dtype=np.uint8)


@dataclass
class BidStream:
    """The generated stream: the Kafka records a partition and the bids'
    columns in bid order (the oracles read these, not the JSON)."""

    partitions: List[List[KafkaRecord]]
    auction: np.ndarray
    bidder: np.ndarray
    price: np.ndarray
    date_time_us: np.ndarray
    timestamp_ms: np.ndarray
    partition: np.ndarray
    offset: np.ndarray
    json_bytes: int

    @property
    def num_bids(self) -> int:
        return len(self.auction)


def _reverse32(k: np.ndarray) -> np.ndarray:
    """Java's Integer.reverse on non-negative ints below 2^31."""
    out = np.zeros_like(k, dtype=np.uint32)
    v = k.astype(np.uint32)
    for _ in range(32):
        out = (out << np.uint32(1)) | (v & np.uint32(1))
        v = v >> np.uint32(1)
    return out.astype(np.int32)


def generate_bids(num_bids: int, seed: int = 0,
                  partitions: int = N_PARTITIONS) -> BidStream:
    """`num_bids` Nexmark bids from `seed`, as Kafka records over
    `partitions` partitions (see the module's docstring)."""
    rng = np.random.default_rng(seed)
    n = int(num_bids)
    i = np.arange(n, dtype=np.int64)
    total = PERSON_PROPORTION + AUCTION_PROPORTION + BID_PROPORTION
    first_bid = PERSON_PROPORTION + AUCTION_PROPORTION
    event_id = (i // BID_PROPORTION) * total + first_bid + i % BID_PROPORTION
    epoch = event_id // total
    last_auction = epoch * AUCTION_PROPORTION + AUCTION_PROPORTION - 1
    last_person = epoch * PERSON_PROPORTION + PERSON_PROPORTION - 1

    hot = rng.integers(0, HOT_AUCTION_RATIO, n) > 0
    lo = np.maximum(last_auction - NUM_IN_FLIGHT_AUCTIONS, 0)
    span = last_auction - lo + 1 + AUCTION_ID_LEAD
    cold = lo + (rng.random(n) * span).astype(np.int64)
    auction = np.where(hot, (last_auction // HOT_AUCTION_RATIO)
                       * HOT_AUCTION_RATIO, cold) + FIRST_AUCTION_ID

    hot = rng.integers(0, HOT_BIDDERS_RATIO, n) > 0
    people = last_person + 1
    active = np.minimum(people, NUM_ACTIVE_PEOPLE)
    cold = people - active + (rng.random(n) * (active + PERSON_ID_LEAD)
                              ).astype(np.int64)
    bidder = np.where(hot, (last_person // HOT_BIDDERS_RATIO)
                      * HOT_BIDDERS_RATIO + 1, cold) + FIRST_PERSON_ID

    price = np.floor(10.0 ** (rng.random(n) * 6.0) * 100.0 + 0.5
                     ).astype(np.int64)

    hot = rng.integers(0, 2, n) > 0
    hot_i = rng.integers(0, len(HOT_CHANNELS), n)
    chan_k = rng.integers(0, CHANNELS_NUMBER, n)
    chan_rev = _reverse32(chan_k)

    desired = AVG_BID_BYTE_SIZE - 4 * 8
    delta = int(round(desired * 0.2))
    extra_len = desired - delta + rng.integers(0, 2 * delta, n)
    pool = _LETTERS[rng.integers(0, len(_LETTERS), int(extra_len.sum()))
                    ].tobytes().decode("ascii")
    ends = np.cumsum(extra_len)

    date_time_us = BASE_TIME_MS * 1000 + i * (1_000_000 // FIRST_EVENT_RATE)
    timestamp_ms = date_time_us // 1000
    part = i % partitions
    offset = i // partitions

    hot_names = [c.lower() for c in HOT_CHANNELS]
    channels = [HOT_CHANNELS[i] if h else f"channel-{k}" for h, i, k in
                zip(hot.tolist(), hot_i.tolist(), chan_k.tolist())]
    urls = [f"https://www.nexmark.com/{hot_names[i]}/item.htm?query=1" if h
            else f"https://www.nexmark.com/item.htm?query=1&channel_id={r}"
            for h, i, r in zip(hot.tolist(), hot_i.tolist(),
                               chan_rev.tolist())]
    ends_l = ends.tolist()
    extras = [pool[a:b] for a, b in zip([0] + ends_l[:-1], ends_l)]
    values = [(f'{{"auction":{a},"bidder":{b},"price":{p},'
               f'"channel":"{c}","url":"{u}","dateTime":{t},'
               f'"extra":"{e}"}}').encode("ascii")
              for a, b, p, c, u, t, e in zip(
                  auction.tolist(), bidder.tolist(), price.tolist(),
                  channels, urls, date_time_us.tolist(), extras)]
    json_bytes = sum(map(len, values))
    ms_l = timestamp_ms.tolist()
    parts: List[List[KafkaRecord]] = [
        [KafkaRecord(values[r], None, r // partitions, p, ms_l[r])
         for r in range(p, n, partitions)] for p in range(partitions)]
    return BidStream(parts, auction, bidder, price, date_time_us,
                     timestamp_ms, part, offset, json_bytes)


# -- the COMPILE PLANs ---------------------------------------------------------

def _source_node(node_id: int = 1) -> dict:
    return {"id": node_id, "type": "stream-exec-table-source-scan_1",
            "scanTableSource": {"table": {
                "identifier": "`default_catalog`.`default_database`.`bid`",
                "resolvedTable": {
                    "schema": {"columns": [
                        {"name": name, "dataType": t}
                        for name, t in BID_COLUMNS]},
                    "options": {"connector": "kafka", "topic": TOPIC,
                                "properties.group.id": "nexmark",
                                "scan.startup.mode": "earliest-offset",
                                "format": "json"}}}},
            "outputType": "ROW<" + ", ".join(
                f"`{name}` {t}" for name, t in BID_COLUMNS) + ">"}


def _ref(i: int, t: str = "BIGINT") -> dict:
    return {"kind": "INPUT_REF", "inputIndex": i, "type": t}


def _lit(v, t: str) -> dict:
    return {"kind": "LITERAL", "value": v, "type": t}


def _call(op: str, operands: list, t: str) -> dict:
    return {"kind": "CALL", "internalName": f"${op}$1",
            "operands": operands, "type": t}


def _chain(nodes: List[dict]) -> dict:
    return {"flinkVersion": "1.18", "nodes": nodes,
            "edges": [{"source": a["id"], "target": b["id"],
                       "shuffle": {"type": "FORWARD"},
                       "shuffleMode": "PIPELINED"}
                      for a, b in zip(nodes, nodes[1:])]}


def _sink_node(node_id: int, table: str) -> dict:
    return {"id": node_id, "type": "stream-exec-sink_1",
            "dynamicTableSink": {"table": {
                "identifier": f"`default_catalog`.`default_database`."
                              f"`{table}`"}}}


def q2_plan() -> dict:
    """Nexmark q2: SELECT auction, price FROM bid WHERE MOD(auction, 123)
    = 0."""
    cond = _call("=", [_call("MOD", [_ref(0), _lit(123, "INT")], "BIGINT"),
                       _lit(0, "INT")], "BOOLEAN")
    return _chain([
        _source_node(1),
        {"id": 2, "type": "stream-exec-calc_1",
         "projection": [_ref(0), _ref(2)], "condition": cond,
         "outputType": "ROW<`auction` BIGINT, `price` BIGINT>"},
        _sink_node(3, "nexmark_q2")])


#: q17's aggregate calls as kept: count(*), min, max, sum and avg of price
Q17_CALLS = (("total_bids", "COUNT", []), ("min_price", "MIN", [1]),
             ("max_price", "MAX", [1]), ("sum_price", "SUM", [1]),
             ("avg_price", "AVG", [1]))


def q17_plan() -> dict:
    """A reduced Nexmark q17: the TWO_PHASE local -> exchange -> global
    group aggregate `SELECT auction, count(*), min(price), max(price),
    sum(price), avg(price) FROM bid GROUP BY auction`.

    Dropped from q17 (the converter takes neither: convert/flink.py
    `_FNS` has no DATE_FORMAT, `convert_agg_call` no FILTER clause): the
    `DATE_FORMAT(dateTime, 'yyyy-MM-dd')` day key and the three `count(*)
    FILTER (WHERE price < 10000 / ...)` rank counts."""
    calls = [{"name": name, "internalName": f"${fn}$1", "argList": args,
              "distinct": False, "approximate": False, "ignoreNulls": False,
              "type": "BIGINT NOT NULL" if fn == "COUNT" else "BIGINT"}
             for name, fn, args in Q17_CALLS]
    return _chain([
        _source_node(1),
        {"id": 2, "type": "stream-exec-calc_1",
         "projection": [_ref(0), _ref(2)], "condition": None,
         "outputType": "ROW<`auction` BIGINT, `price` BIGINT>"},
        {"id": 3, "type": "stream-exec-local-group-aggregate_1",
         "grouping": [0], "aggCalls": calls, "aggCallNeedRetractions":
             [False] * len(calls), "needRetraction": False},
        {"id": 4, "type": "stream-exec-exchange_1",
         "inputProperties": [{"requiredDistribution": {
             "type": "HASH", "keys": [0]}}]},
        {"id": 5, "type": "stream-exec-global-group-aggregate_1",
         "grouping": [0], "aggCalls": calls, "aggCallNeedRetractions":
             [False] * len(calls), "generateUpdateBefore": True,
         "needRetraction": False},
        _sink_node(6, "nexmark_q17")])


def calc_plan() -> dict:
    """The windowed stream's Calc: SELECT auction, price FROM bid."""
    return _chain([
        _source_node(1),
        {"id": 2, "type": "stream-exec-calc_1",
         "projection": [_ref(0), _ref(2)], "condition": None,
         "outputType": "ROW<`auction` BIGINT, `price` BIGINT>"},
        _sink_node(3, "nexmark_window")])


PLANS: Dict[str, object] = {"q2": q2_plan, "q17": q17_plan,
                            "calc": calc_plan}


def plan_json(name: str) -> str:
    """A plan as the JSON text Flink writes."""
    return json.dumps(PLANS[name]())
