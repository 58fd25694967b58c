"""Audio preprocessing of the port: spectrogram frame folders for the
audionet branch (``spectrograms``) and their folder clean-up
(``postproc_folders``)."""
