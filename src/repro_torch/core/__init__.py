"""Core library: MC-dropout masks (``prng``, ``mcd``), LSTM cells and
stacks (``cells``, ``rnn``, ``linear``), the ECG classifier and its
chain-axis uncertainty (``classifier``, ``uncertainty``)."""
