"""Star/snowflake schema model.

The paper (§3.1) scopes the cache to dashboard-style aggregations over a star or
snowflake schema with a single fact table and dimension joins along schema-defined
foreign keys.  This module is the schema contract every other core component
(canonicalizer, validator, derivations, OLAP executor) works against.

Terminology follows the paper: a *dimension* is a conceptual grouping (Time,
Geography); a *level* is a granularity within a dimension hierarchy
(Year > Quarter > Month).  Hierarchies are declared fine -> coarse and are
functional (each child maps to exactly one parent) unless flagged otherwise —
roll-up derivations require summarizability (§3.6).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

NUMERIC = ("int", "float")


@dataclasses.dataclass(frozen=True)
class Column:
    name: str
    dtype: str  # 'int' | 'float' | 'str' | 'date'

    def is_numeric(self) -> bool:
        return self.dtype in NUMERIC


@dataclasses.dataclass(frozen=True)
class Hierarchy:
    """An ordered list of levels, finest first (e.g. day < month < quarter < year)."""

    name: str
    levels: tuple[str, ...]  # column names within the owning dimension, fine -> coarse
    summarizable: bool = True  # functional child->parent mapping at every step

    def is_ancestor(self, coarse: str, fine: str) -> bool:
        """True iff ``coarse`` is a strict ancestor of ``fine`` in this hierarchy."""
        if coarse not in self.levels or fine not in self.levels:
            return False
        return self.levels.index(coarse) > self.levels.index(fine)


@dataclasses.dataclass(frozen=True)
class Dimension:
    """A dimension table joined to the fact along a schema-defined foreign key.

    Role-playing dimensions (one physical table joined twice, e.g. pickup/dropoff
    dates) must be declared as *separate* Dimension objects with distinct names
    and distinct fact FKs — this is what keeps join paths unique (§3.3).
    """

    name: str
    fact_fk: str  # foreign-key column on the fact table
    pk: str  # primary-key column on this dimension
    columns: tuple[Column, ...]
    hierarchies: tuple[Hierarchy, ...] = ()
    # Time semantics per column, for window canonicalization (§3.3): maps a
    # column name to one of {'date','year','yearmonthnum','yearmonth_str',
    # 'yearquarter_str'}.  Levels without an entry stay ordinary filters.
    time_kinds: tuple[tuple[str, str], ...] = ()

    def time_kind(self, col: str) -> Optional[str]:
        for c, k in self.time_kinds:
            if c == col:
                return k
        return None

    def column(self, name: str) -> Optional[Column]:
        for c in self.columns:
            if c.name == name:
                return c
        return None

    def hierarchy_of(self, level: str) -> Optional[Hierarchy]:
        for h in self.hierarchies:
            if level in h.levels:
                return h
        return None


@dataclasses.dataclass(frozen=True)
class FactTable:
    name: str
    columns: tuple[Column, ...]  # measures + foreign keys + degenerate dims
    date_column: Optional[str] = None  # raw date column used for time windows

    def column(self, name: str) -> Optional[Column]:
        for c in self.columns:
            if c.name == name:
                return c
        return None


class AmbiguousColumn(Exception):
    """An unqualified column name resolves to more than one (table, column)."""


class UnknownColumn(Exception):
    """A column reference does not exist anywhere in the schema."""


@dataclasses.dataclass(frozen=True)
class StarSchema:
    name: str
    fact: FactTable
    dimensions: tuple[Dimension, ...]
    # The dimension (by name) that carries the time hierarchy, if any.  Time
    # windows (§3.3) are expressed against either fact.date_column or this
    # dimension's date-valued pk attribute.
    time_dimension: Optional[str] = None

    # ------------------------------------------------------------------ lookup
    def dimension(self, name: str) -> Optional[Dimension]:
        for d in self.dimensions:
            if d.name == name:
                return d
        return None

    def tables(self) -> dict[str, tuple[Column, ...]]:
        out = {self.fact.name: self.fact.columns}
        for d in self.dimensions:
            out[d.name] = d.columns
        return out

    def resolve_column(self, name: str, table: Optional[str] = None) -> tuple[str, Column]:
        """Resolve a (possibly unqualified) column reference to (table, Column).

        Raises AmbiguousColumn when an unqualified name appears in several
        tables — the paper bypasses such requests rather than guessing.
        """
        if table is not None:
            cols = self.tables().get(table)
            if cols is None:
                raise UnknownColumn(f"unknown table {table!r}")
            for c in cols:
                if c.name == name:
                    return table, c
            raise UnknownColumn(f"column {table}.{name} does not exist")
        hits: list[tuple[str, Column]] = []
        for tname, cols in self.tables().items():
            for c in cols:
                if c.name == name:
                    hits.append((tname, c))
        if not hits:
            raise UnknownColumn(f"column {name!r} does not exist in schema {self.name!r}")
        if len(hits) > 1:
            raise AmbiguousColumn(
                f"column {name!r} is ambiguous: {[t for t, _ in hits]}"
            )
        return hits[0]

    def join_path(self, dim_name: str) -> str:
        """Return the fact FK joining ``dim_name``; unique by construction.

        Uniqueness holds because role-playing joins are modeled as separate
        Dimension objects.  A dimension name that does not exist raises.
        """
        d = self.dimension(dim_name)
        if d is None:
            raise UnknownColumn(f"unknown dimension {dim_name!r}")
        return d.fact_fk

    def time_levels(self) -> tuple[str, ...]:
        """Levels of the time dimension's primary hierarchy (fine->coarse)."""
        if self.time_dimension is None:
            return ()
        d = self.dimension(self.time_dimension)
        if d is None or not d.hierarchies:
            return ()
        return d.hierarchies[0].levels

    def is_time_level(self, dim: str, col: str) -> bool:
        return self.time_dimension is not None and dim == self.time_dimension

    def validate(self) -> None:
        """Structural self-check (used by tests and workload constructors)."""
        fact_cols = {c.name for c in self.fact.columns}
        seen_fks: set[str] = set()
        for d in self.dimensions:
            if d.fact_fk not in fact_cols:
                raise ValueError(f"dim {d.name}: fk {d.fact_fk} missing from fact")
            if d.fact_fk in seen_fks:
                raise ValueError(f"fk {d.fact_fk} reused — join path not unique")
            seen_fks.add(d.fact_fk)
            if d.column(d.pk) is None:
                raise ValueError(f"dim {d.name}: pk {d.pk} missing")
            for h in d.hierarchies:
                for lvl in h.levels:
                    if d.column(lvl) is None:
                        raise ValueError(f"dim {d.name}: hierarchy level {lvl} missing")
        if self.time_dimension is not None and self.dimension(self.time_dimension) is None:
            raise ValueError(f"time dimension {self.time_dimension!r} missing")
