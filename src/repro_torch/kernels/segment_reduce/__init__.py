"""The four statistics of PNA's aggregation over CSR rows on the card: the
sums of float32 messages and of their squares, their maxima and minima,
from one read of the messages."""
