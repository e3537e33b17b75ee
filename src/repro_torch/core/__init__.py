"""FINGER core of the port: Lemma-1 Q, FINGER-H̃, Theorem-2 updates and
the incremental Jensen–Shannon distance (Algorithm 2)."""
