"""One driver a kind of traffic: ``bulk`` (batches of texts to waveforms),
``stream`` (one streamed synthesis at a time) and ``train`` (the forward
model's train step). A cell's file names its driver and holds every number
of its traffic."""
