from repro_torch.storage.aio import AsyncIOEngine, ReadTicket
from repro_torch.storage.backend import (Backend, DRAMBackend,
                                         FileBackend, SimulatedSSD,
                                         StorageArray, make_array)
from repro_torch.storage.chunk_store import (AsyncRead, ChunkStore,
                                             LayerRead)
from repro_torch.storage.shard import (HostShard, NICLink, ShardTopology,
                                       flatten_shards, make_shards)
from repro_torch.storage.two_stage import (DirectSaver, SnapshotTask,
                                           TwoStageSaver)

__all__ = ["AsyncIOEngine", "ReadTicket", "Backend", "DRAMBackend",
           "FileBackend", "SimulatedSSD", "StorageArray", "make_array",
           "AsyncRead", "ChunkStore", "LayerRead", "HostShard", "NICLink",
           "ShardTopology", "flatten_shards", "make_shards", "DirectSaver",
           "SnapshotTask", "TwoStageSaver"]
