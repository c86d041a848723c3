"""Core library: MC-dropout masks (``prng``, ``mcd``), LSTM / GRU cells and
stacks (``cells``, ``rnn``, ``linear``), the ECG classifier and anomaly
autoencoder and their chain-axis uncertainty (``classifier``,
``autoencoder``, ``uncertainty``), the S-sample predictive engine
(``bayesian.predict``) and the distilled students (``distill``)."""
