"""Data readers (counterpart of ``transmogrifai_tpu.readers``): the
in-memory, CSV, JSON-lines and Avro readers, the event readers
(aggregate, conditional, joined; in core and streamed), the micro-batch
streaming readers and the ingestion resilience policies."""
from .base import (Reader, DataFrameReader, RecordsReader,  # noqa: F401
                   reader_for, ChunkStream)
from .streaming import (AsyncBatcher, FileStreamingReader,  # noqa: F401
                        IteratorStreamingReader, StreamingReader,
                        StreamingReaders)
from .files import (CSVReader, CSVAutoReader, ParquetReader,  # noqa: F401
                    JSONLinesReader, DataReaders)
from .aggregates import (AggregateDataReader, ConditionalDataReader,  # noqa: F401
                         JoinedDataReader, JoinedAggregateDataReader,
                         TimeBasedFilter)
from .events import (StreamingAggregateReader,  # noqa: F401
                     StreamingConditionalReader, EventFoldState,
                     merge_fold_states, key_owner, streaming_view)
from .avro import (AvroReader, AvroSchemaCSVReader, read_avro,  # noqa: F401
                   write_avro, schema_feature_types)
