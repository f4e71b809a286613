"""Core: OLAP intent signatures, SQL canonicalization, validation, and the
semantic cache with correctness-preserving derivations."""

from .cache import CacheStats, LookupResult, SemanticCache
from .schema import Column, Dimension, FactTable, Hierarchy, StarSchema
from .signature import (
    Filter,
    HavingClause,
    Measure,
    OrderKey,
    Signature,
    TimeWindow,
    signature_from_json,
)
from .sql_canon import CanonicalizationError, SQLCanonicalizer
from .sqlparse import SQLSyntaxError, UnsupportedQuery
from .table import ResultTable
from .validator import SignatureValidator

__all__ = [
    "CacheStats", "CanonicalizationError", "Column", "Dimension", "FactTable",
    "Filter", "HavingClause", "Hierarchy", "LookupResult", "Measure",
    "OrderKey", "ResultTable", "SQLCanonicalizer", "SQLSyntaxError",
    "SemanticCache", "Signature", "SignatureValidator", "StarSchema",
    "TimeWindow", "UnsupportedQuery", "signature_from_json",
]
