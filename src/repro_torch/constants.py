"""Shared numeric sentinels, the same values as the reference package's.

``NEG_INF`` is a finite stand-in for -inf: a dead top-K slot carries it,
and it underflows ``exp`` to exactly 0 against any realistic score
without the nan that a real -inf makes in max-subtracted softmax.

``LOG_Q_PAD`` is the log-proposal value of padded or masked sample
slots, and ``LOG_Q_VALID_MAX`` the threshold that tells them apart from
real log-proposals (the training slice uses both).
"""
from __future__ import annotations

NEG_INF = -3.0e38
LOG_Q_PAD = 3.0e38
LOG_Q_VALID_MAX = 1.5e38
