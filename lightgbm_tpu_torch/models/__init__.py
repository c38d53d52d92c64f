"""Boosting models (reference: src/boosting/boosting.cpp)."""

from __future__ import annotations


def create_boosting(config, train_set, objective, training_metrics=()):
    """The booster of `config.boosting` (Boosting::CreateBoosting,
    boosting.cpp:42-90; the JAX package's models/__init__.py): gbdt, dart
    or rf ("goss" resolves to gbdt with the GOSS sample strategy in the
    config)."""
    from .dart import DART
    from .gbdt import GBDT
    from .rf import RF

    b = config.boosting
    if b == "dart":
        return DART(config, train_set, objective, training_metrics)
    if b == "rf":
        return RF(config, train_set, objective, training_metrics)
    return GBDT(config, train_set, objective, training_metrics)
