"""Applications of Algorithm 1 (kNN classification, user-based CF)."""
