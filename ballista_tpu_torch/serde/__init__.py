"""Wire encodings (port of ballista_tpu/serde): the logical-plan codec
(`plans`) and the task, status, executor-registration and job-spec codecs
(`tasks`). Host only."""
