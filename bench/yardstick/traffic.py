"""The one traffic generator: it reads a mix's parameters
(``bench/traffic/<mix>.json``) and draws, from the run's seed, the
requests of the warm-up and of the measured window.

A request is a structured intent with the SQL text of one of its 21
surface forms (drawn uniformly), or in a mix of ``"form": "nl"`` with the
natural-language text of one of ``nlforms``' phrasings instead (drawn
uniformly from a stream of the seed's own: the mix draws every other
number as its SQL form does, and asks the same intents at the same
times).  An event is what one caller hands to
``CacheService.submit_batch`` at once: a dashboard's tiles, or one
request.  Parameters:

* ``form``: ``sql`` (the default) or ``nl``: what the requests carry;
* ``loop``: ``open`` (events due at the times of a Poisson process of
  ``rate_per_s``, handed to ``callers`` threads) or ``closed``
  (``clients`` threads, each submitting its next event as soon as its
  last returned, from ``max_events`` drawn);
* ``dashboards``: the size of the population of dashboards, chosen by a
  Zipf law of exponent ``zipf_s`` over ranks; 0 draws a new dashboard for
  every event (uniform over flights and literals);
* ``tiles``: tiles per dashboard;
* ``events``: the share of each kind: ``refresh`` (every tile of a
  dashboard), ``drill``, ``roll``, ``window`` (one tile moved, see
  ``flights``), ``single`` (one intent of its own);
* ``fresh``: requests with the forced freshness of a scheduled refresh
  (the cache is not read, the result stored anew);
* ``drill_into_share``: the share of drills that keep the grouping and only
  narrow to a member;
* ``regroup``: whether each grouping level is drawn over its hierarchy;
* ``price_floor_share``: the share of dashboards (or single intents) that
  add a floor on the order's price (their misses take kernel A);
* ``balanced``: draw the flights in rounds that hold each of them once,
  and the price floors as one in every ``1 / price_floor_share`` intents,
  each round in an order of its own, so that every window asks for the
  same mix of work;
* ``warmup_events``: events of the untimed warm-up stream;
* ``check``: how many answers of each class the comparison takes.

The same seed gives the same events, in the same order, with the same
due times.
"""
from __future__ import annotations

import dataclasses
import itertools
import json
import random
from pathlib import Path

import numpy as np

from . import flights, nlforms, sqlforms
from .flights import Intent

TRAFFIC_DIR = Path(__file__).resolve().parents[1] / "traffic"


@dataclasses.dataclass(frozen=True)
class Request:
    intent: Intent
    form: int  # of sqlforms, or of nlforms where ``nl`` is set
    sql: str  # empty where ``nl`` is set
    kind: str  # the event kind that asked it
    nl: str | None = None  # the question in natural language


@dataclasses.dataclass(frozen=True)
class Event:
    due_s: float  # seconds after the window opens (open loop); 0 when closed
    kind: str
    requests: tuple[Request, ...]


def load(mix: str) -> dict:
    return json.loads((TRAFFIC_DIR / f"{mix}.json").read_text())


class Generator:
    def __init__(self, params: dict, seed: int, stream: str):
        """``stream`` names the draw ("warmup" or "window"): the two are
        independent streams of one seed."""
        self.p = params
        self.rng = random.Random(f"{seed}|{stream}")
        self.form = params.get("form", "sql")
        if self.form not in ("sql", "nl"):
            raise ValueError(f"unknown form {self.form!r}: sql or nl")
        self.nl_rng = random.Random(f"{seed}|{stream}|nl")
        n = int(params.get("dashboards", 0))
        boards = random.Random(f"{seed}|dashboards")
        self.boards = [self._board(boards) for _ in range(n)]
        if n:
            w = np.arange(1, n + 1, dtype=np.float64) ** -float(params["zipf_s"])
            self.cdf = np.cumsum(w / w.sum())
        self.decks: dict[str, list] = {}
        kinds = sorted(params["events"])
        self.kinds = kinds
        self.kind_cdf = list(itertools.accumulate(params["events"][k] for k in kinds))

    def _deal(self, name: str, cards: list, rng: random.Random):
        """The next card of a deck that is shuffled anew when empty."""
        deck = self.decks.get(name)
        if not deck:
            deck = self.decks[name] = list(cards)
            rng.shuffle(deck)
        return deck.pop()

    def _base(self, rng: random.Random) -> Intent:
        share = float(self.p.get("price_floor_share", 0.0))
        if self.p.get("balanced"):
            it = flights.draw(rng, self._deal("flights", sorted(flights.FLIGHTS), rng))
            n = round(1 / share) if share else 0
            floor = bool(n) and self._deal("floors", [True] + [False] * (n - 1), rng)
        else:
            it = flights.draw(rng)
            floor = rng.random() < share
        if self.p.get("regroup"):
            it = flights.regroup(it, rng)
        if floor:
            it = flights.with_price_floor(it, rng)
        return it

    def _board(self, rng: random.Random) -> list[Intent]:
        return flights.tiles(self._base(rng), int(self.p.get("tiles", 6)))

    def _pick_board(self) -> list[Intent]:
        if not self.boards:
            return self._board(self.rng)
        i = int(np.searchsorted(self.cdf, self.rng.random(), side="right"))
        return self.boards[min(i, len(self.boards) - 1)]

    def _request(self, it: Intent, kind: str, form: str | None = None) -> Request:
        """The request of ``it`` in the mix's form, or in ``form``.  An NL
        request draws its SQL form too, unused, so that a mix asks the same
        intents at the same times in either form."""
        f = self.rng.randrange(sqlforms.N_FORMS)
        if (form or self.form) == "nl":
            f = self.nl_rng.randrange(nlforms.N_FORMS)
            return Request(it, f, "", kind, nlforms.render(it, f))
        return Request(it, f, sqlforms.render(it, f), kind)

    def event(self, due_s: float = 0.0) -> Event:
        u = self.rng.random() * self.kind_cdf[-1]
        kind = self.kinds[min(len(self.kinds) - 1, sum(1 for c in self.kind_cdf if c <= u))]
        if kind == "single":
            its = [self._base(self.rng)]
        else:
            board = self._pick_board()
            if kind == "refresh":
                its = board
            else:
                tile = self.rng.choice(board)
                if kind == "drill":
                    its = [flights.drill(tile, self.rng, float(self.p.get("drill_into_share", 0.0)))]
                elif kind == "roll":
                    its = [flights.roll(tile, self.rng)]
                elif kind == "window":
                    its = [flights.window_move(tile, self.rng)]
                else:
                    raise ValueError(f"unknown event kind {kind!r}")
        return Event(due_s, kind, tuple(self._request(it, kind) for it in its))

    def schedule(self, seconds: float, rate: float | None = None) -> list[Event]:
        """Open loop: the events due in ``seconds`` at ``rate`` per second
        (default: the mix's), Poisson arrivals.  Closed loop: ``max_events``
        events, due at once."""
        if self.p["loop"] == "closed":
            return [self.event() for _ in range(int(self.p["max_events"]))]
        rate = float(rate or self.p["rate_per_s"])
        out, t = [], 0.0
        while True:
            t += self.rng.expovariate(rate)
            if t >= seconds:
                return out
            out.append(self.event(t))

    def warmup(self) -> list[Event]:
        return [self.event() for _ in range(int(self.p.get("warmup_events", 0)))]


def level_space(params: dict) -> list[Intent]:
    """One intent for every grouping the mix can ask for, so that set-up
    builds each grouping's level codes and group ids: per flight, every
    subset of its grouping slots with every level of each slot's hierarchy
    where the mix regroups or drills and rolls, else the flight's own; a
    flight without grouping also by month (its drill)."""
    rng = random.Random("level_space")
    moves = bool(params.get("regroup")) or any(
        params["events"].get(k) for k in ("drill", "roll"))
    seen, out = set(), []
    for name in sorted(flights.FLIGHTS):
        it = flights.draw(rng, name)
        slots = [flights.HIERARCHIES[flights.HIERARCHY_OF[lv]] for lv in it.levels]
        if not moves:
            options = [it.levels]
        else:
            options = [()] if it.levels else [(), ("dates.d_yearmonth",)]
            for r in range(1, len(slots) + 1):
                for sub in itertools.combinations(slots, r):
                    options += list(itertools.product(*sub))
        for levels in options:
            key = (frozenset(levels), it.measure)
            if key not in seen:
                seen.add(key)
                out.append(dataclasses.replace(it, levels=tuple(levels)))
    return out

