"""The port's language-model stack: layers, aggregated-KV caches, decoder
blocks and the decode API (``model.init_params`` / ``init_caches`` /
``serve_step``)."""
