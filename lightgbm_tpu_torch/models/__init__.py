"""Boosting models (reference: src/boosting/boosting.cpp)."""
